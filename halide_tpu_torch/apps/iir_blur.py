"""iir_blur: first-order IIR low-pass, down+up each axis
(reference: apps/iir_blur/iir_blur_generator.cpp:13-33,147-156).

Each axis is scanned in place, forward then backward: four constant-
coefficient f32 scans per frame, each one launch of the scan kernel
(ops/scan_kernel, K2a) on the card."""
from __future__ import annotations

import numpy as np

import halide_tpu_torch as hl

from . import App, register


def _blur_axis(inp, extent, alpha, axis, tag):
    """Down+up first-order IIR along `axis` (0 = y rows, 1 = x columns),
    scanned in place (the reference filters columns and transposes twice,
    apps/iir_blur/iir_blur_generator.cpp:13-33, a CPU cache-locality trick;
    the scan kernel takes either axis through its strides)."""
    x, y, c = hl.Var("x"), hl.Var("y"), hl.Var("c")
    blur = hl.Func(f"iblur_{tag}")
    blur[x, y, c] = hl.undef(hl.Float(32))
    r = hl.RDom(1, extent - 1)
    if axis == 0:
        blur[x, 0, c] = inp[x, 0, c]
        blur[x, r.x, c] = (1 - alpha) * blur[x, r.x - 1, c] \
            + alpha * inp[x, r.x, c]
        flip = extent - r.x - 1
        blur[x, flip, c] = (1 - alpha) * blur[x, flip + 1, c] \
            + alpha * blur[x, flip, c]
    else:
        blur[0, y, c] = inp[0, y, c]
        blur[r.x, y, c] = (1 - alpha) * blur[r.x - 1, y, c] \
            + alpha * inp[r.x, y, c]
        flip = extent - r.x - 1
        blur[flip, y, c] = (1 - alpha) * blur[flip + 1, y, c] \
            + alpha * blur[flip, y, c]
    return blur


@register("iir_blur")
def build(width: int = 1536, height: int = 2560, alpha: float = 0.1) -> App:
    inp = hl.ImageParam(hl.Float(32), 3, "input")
    blury = _blur_axis(inp, height, alpha, 0, "y")
    blur = _blur_axis(blury, width, alpha, 1, "x")

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"input": rng.random((3, height, width), np.float32)}

    def reference(input):
        a = np.float64(alpha)

        def iir_cols(img):  # img np[c, h, w]; filter along h, then transpose
            v = img.astype(np.float64).copy()
            for i in range(1, v.shape[1]):
                v[:, i] = (1 - a) * v[:, i - 1] + a * img[:, i]
            for i in range(v.shape[1] - 2, -1, -1):
                v[:, i] = (1 - a) * v[:, i + 1] + a * v[:, i]
            return np.swapaxes(v, 1, 2)

        return iir_cols(iir_cols(input)).astype(np.float32)

    return App("iir_blur", hl.Pipeline(blur), [inp], make_inputs, reference,
               [width, height, 3], megapixels=width * height / 1e6,
               tolerance=2e-3, atol=2e-3)

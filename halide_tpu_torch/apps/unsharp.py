"""unsharp: gaussian blur + sharpen mask, float
(reference: apps/unsharp/unsharp_generator.cpp:17-51)."""
from __future__ import annotations

import math

import numpy as np

import halide_tpu_torch as hl

from . import App, register

SIGMA = 1.5


@register("unsharp")
def build(width: int = 1536, height: int = 2560) -> App:
    x, y, c = hl.Var("x"), hl.Var("y"), hl.Var("c")
    inp = hl.ImageParam(hl.Float(32), 3, "input")

    kPi = 3.14159265358979310000

    kernel = hl.Func("kernel")
    kernel[x] = hl.exp(-x * x / (2.0 * SIGMA * SIGMA)) / \
        (math.sqrt(2.0 * kPi) * SIGMA)

    bounded = hl.repeat_edge(inp)

    gray = hl.Func("gray")
    gray[x, y] = (0.299 * bounded[x, y, 0] + 0.587 * bounded[x, y, 1]
                  + 0.114 * bounded[x, y, 2])
    # stage the reused producers (the reference's CPU schedule stages these
    # per strip; inline would recompute gray ~49x through the blur taps)
    gray.compute_root()

    blur_y = hl.Func("blur_y")
    blur_y[x, y] = (kernel[0] * gray[x, y]
                    + kernel[1] * (gray[x, y - 1] + gray[x, y + 1])
                    + kernel[2] * (gray[x, y - 2] + gray[x, y + 2])
                    + kernel[3] * (gray[x, y - 3] + gray[x, y + 3]))

    blur_x = hl.Func("blur_x")
    blur_x[x, y] = (kernel[0] * blur_y[x, y]
                    + kernel[1] * (blur_y[x - 1, y] + blur_y[x + 1, y])
                    + kernel[2] * (blur_y[x - 2, y] + blur_y[x + 2, y])
                    + kernel[3] * (blur_y[x - 3, y] + blur_y[x + 3, y]))

    blur_y.compute_root()

    sharpen = hl.Func("sharpen")
    sharpen[x, y] = 2.0 * gray[x, y] - blur_x[x, y]

    ratio = hl.Func("ratio")
    ratio[x, y] = sharpen[x, y] / gray[x, y]

    output = hl.Func("unsharp_out")
    output[x, y, c] = ratio[x, y] * inp[x, y, c]

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"input": rng.random((3, height, width), np.float32) + 0.01}

    def reference(input):
        a = input.astype(np.float32)
        k = np.exp(-(np.arange(4, dtype=np.float32) ** 2)
                   / np.float32(2 * SIGMA * SIGMA)) / \
            np.float32(math.sqrt(2 * kPi) * SIGMA)
        gray_r = (np.float32(0.299) * a[0] + np.float32(0.587) * a[1]
                  + np.float32(0.114) * a[2])
        g = np.pad(gray_r, 3, mode="edge")

        def blur1(img, axis):
            sl = [slice(3, -3)] * 2
            out = k[0] * img[tuple(sl)]
            for i in (1, 2, 3):
                lo = [slice(3, -3)] * 2
                hi = [slice(3, -3)] * 2
                lo[axis] = slice(3 - i, -3 - i)
                hi[axis] = slice(3 + i, (-3 + i) or None)
                out = out + k[i] * (img[tuple(lo)] + img[tuple(hi)])
            return out

        by = blur1(g, 0)
        byp = np.pad(by, 3, mode="edge")
        bx = blur1(byp, 1)
        sharp = 2 * gray_r - bx
        ratio_r = sharp / gray_r
        return ratio_r[None] * a

    return App("unsharp", hl.Pipeline(output), [inp], make_inputs, reference,
               [width, height, 3], megapixels=width * height / 1e6,
               tolerance=2e-4)

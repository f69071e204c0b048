"""resize: separable polyphase resampling with box/linear/cubic/lanczos
kernels (reference: apps/resize/resize_generator.cpp:9-135)."""
from __future__ import annotations

import math

import numpy as np

import halide_tpu_torch as hl

from . import App, register

_TAPS = {"box": 1, "linear": 2, "cubic": 4, "lanczos": 6}


def _kernel_expr(kind, xe):
    xx = hl.abs(xe)
    if kind == "box":
        return hl.select(xx <= 0.5, 1.0, 0.0)
    if kind == "linear":
        return hl.select(xx < 1.0, 1.0 - xx, 0.0)
    if kind == "cubic":
        a = -0.5
        xx2 = xx * xx
        xx3 = xx2 * xx
        return hl.select(
            xx < 1.0, (a + 2.0) * xx3 - (a + 3.0) * xx2 + 1.0,
            hl.select(xx < 2.0,
                      a * xx3 - 5.0 * a * xx2 + 8.0 * a * xx - 4.0 * a,
                      0.0))
    # lanczos
    def sinc(v):
        v = v * 3.14159265359
        return hl.sin(v) / v
    val = sinc(xe) * sinc(xe / 3.0)
    val = hl.select(xe == 0.0, 1.0, val)
    return hl.select(hl.logical_or(xe > 3.0, xe < -3.0), 0.0, val)


def _kernel_np(kind, v):
    ax = np.abs(v)
    if kind == "box":
        return np.where(ax <= 0.5, 1.0, 0.0).astype(np.float32)
    if kind == "linear":
        return np.where(ax < 1.0, 1.0 - ax, 0.0).astype(np.float32)
    if kind == "cubic":
        a = np.float32(-0.5)
        r = np.where(ax < 1.0, (a + 2) * ax**3 - (a + 3) * ax**2 + 1,
                     np.where(ax < 2.0,
                              a * ax**3 - 5 * a * ax**2 + 8 * a * ax - 4 * a,
                              0.0))
        return r.astype(np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        def sinc(u):
            u = u * np.float32(3.14159265359)
            return np.sin(u) / u
        r = sinc(v) * sinc(v / 3)
        r = np.where(v == 0.0, 1.0, r)
        return np.where((v > 3) | (v < -3), 0.0, r).astype(np.float32)


@register("resize")
def build(width: int = 1536, height: int = 2560, scale_factor: float = 0.5,
          interpolation: str = "cubic", upsample: bool = False) -> App:
    x, y, c, k = hl.Var("x"), hl.Var("y"), hl.Var("c"), hl.Var("k")
    inp = hl.ImageParam(hl.Float(32), 3, "input")
    taps = _TAPS[interpolation]
    out_w = int(width * scale_factor)
    out_h = int(height * scale_factor)

    inv_scale = 1.0 / scale_factor
    kernel_scaling = 1.0 if upsample else scale_factor
    inv_kernel_scaling = 1.0 if upsample else inv_scale
    kernel_radius = 0.5 * taps * inv_kernel_scaling
    kernel_taps = int(math.ceil(taps * inv_kernel_scaling))

    sourcex = (x + 0.5) * inv_scale - 0.5
    sourcey = (y + 0.5) * inv_scale - 0.5
    beginx = hl.clamp(hl.i32(hl.ceil(sourcex - kernel_radius)),
                      0, width - kernel_taps)
    beginy = hl.clamp(hl.i32(hl.ceil(sourcey - kernel_radius)),
                      0, height - kernel_taps)

    # schedule (the JAX app's): instead of per-pixel windowed gathers
    # (inp[x, rk + beginy, c] with a data-dependent beginy), the FULL (out x
    # in) kernel matrix is materialized -- banded by the same window
    # predicate, so values match the reference's windowed form exactly --
    # and the tap reduction becomes a dense contraction (an einsum).
    unk_x = hl.Func("unnormalized_kernel_x")
    unk_x[x, k] = hl.select(
        hl.logical_and(k >= beginx, k < beginx + kernel_taps),
        _kernel_expr(interpolation, (k - sourcex) * kernel_scaling), 0.0)
    unk_y = hl.Func("unnormalized_kernel_y")
    unk_y[y, k] = hl.select(
        hl.logical_and(k >= beginy, k < beginy + kernel_taps),
        _kernel_expr(interpolation, (k - sourcey) * kernel_scaling), 0.0)

    rx_full = hl.RDom(0, width, "rkx")
    ry_full = hl.RDom(0, height, "rky")
    ks_x = hl.Func("kernel_sum_x")
    ks_x[x] = hl.sum(unk_x[x, rx_full.x])
    ks_y = hl.Func("kernel_sum_y")
    ks_y[y] = hl.sum(unk_y[y, ry_full.x])
    kernel_x = hl.Func("kernel_x")
    kernel_x[x, k] = unk_x[x, k] / ks_x[x]
    kernel_y = hl.Func("kernel_y")
    kernel_y[y, k] = unk_y[y, k] / ks_y[y]
    kernel_x.compute_root()
    kernel_y.compute_root()

    resized_y = hl.Func("resized_y")
    resized_y[x, y, c] = hl.sum(kernel_y[y, ry_full.x]
                                * inp[x, ry_full.x, c])
    resized_y.compute_root()
    resized_x = hl.Func("resized_x")
    resized_x[x, y, c] = hl.sum(kernel_x[x, rx_full.x]
                                * resized_y[rx_full.x, y, c])

    output = hl.Func("resize_out")
    output[x, y, c] = hl.clamp(resized_x[x, y, c], 0.0, 1.0)

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"input": rng.random((3, height, width), np.float32)}

    def reference(input):
        f = np.float32

        def axis_kernel(n_out, n_in):
            coords = np.arange(n_out)
            source = ((coords + 0.5) * f(inv_scale) - 0.5).astype(f)
            begin = np.clip(np.ceil(source - f(kernel_radius)).astype(np.int32),
                            0, n_in - kernel_taps)
            kk = np.arange(kernel_taps)
            vals = _kernel_np(interpolation,
                              ((kk[None, :] + begin[:, None] - source[:, None])
                               * f(kernel_scaling)).astype(f))
            vals = vals / vals.sum(axis=1, keepdims=True)
            return begin, vals.astype(f)

        by, wy = axis_kernel(out_h, height)
        bx, wx = axis_kernel(out_w, width)
        tmp = np.zeros((3, out_h, width), f)
        for t in range(kernel_taps):
            tmp += wy[:, t][None, :, None] * input[:, by + t, :]
        outp = np.zeros((3, out_h, out_w), f)
        for t in range(kernel_taps):
            outp += wx[:, t][None, None, :] * tmp[:, :, bx + t]
        return np.clip(outp, 0.0, 1.0)

    return App("resize", hl.Pipeline(output), [inp], make_inputs, reference,
               [out_w, out_h, 3], megapixels=out_w * out_h / 1e6,
               tolerance=2e-4, atol=1e-4, mismatch_frac=0.001)

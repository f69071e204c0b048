"""hist: histogram-equalization in YCbCr
(reference: apps/hist/hist_generator.cpp:16-54 -- per-row histograms,
summed, cdf scan, LUT-equalize, recombine).

The per-row histograms are a constant-value row histogram: at the canonical
size (2560 rows of 1536 pixels into 256 bins) one launch of the row-
histogram kernel (ops/rowhist_kernel, K3) on the card. The cdf is an int32
scan in log-depth rounds of torch ops; the column sum a dense reduction."""
from __future__ import annotations

import numpy as np

import halide_tpu_torch as hl

from . import App, register


@register("hist")
def build(width: int = 1536, height: int = 2560) -> App:
    x, y, c = hl.Var("x"), hl.Var("y"), hl.Var("c")
    inp = hl.ImageParam(hl.UInt(8), 3, "input")

    Y = hl.Func("Y")
    Y[x, y] = (0.299 * inp[x, y, 0] + 0.587 * inp[x, y, 1]
               + 0.114 * inp[x, y, 2])

    Cr = hl.Func("Cr")
    Cr[x, y] = (inp[x, y, 0] - Y[x, y]) * 0.713 + 128.0
    Cb = hl.Func("Cb")
    Cb[x, y] = (inp[x, y, 2] - Y[x, y]) * 0.564 + 128.0

    hist_rows = hl.Func("hist_rows")
    hist_rows[x, y] = 0
    rx = hl.RDom(0, inp.width(), "rx")
    bin_ = hl.i32(hl.clamp(Y[rx.x, y], 0.0, 255.0))
    hist_rows[bin_, y] += 1

    hist = hl.Func("hist")
    hist[x] = 0
    ry = hl.RDom(0, inp.height(), "ry")
    hist[x] += hist_rows[x, ry.x]

    cdf = hl.Func("cdf")
    cdf[x] = hist[0]
    b = hl.RDom(1, 255, "b")
    cdf[b.x] = cdf[b.x - 1] + hist[b.x]
    cdf.bound(x, 0, 256)

    cdf_bin = hl.Func("cdf_bin")
    cdf_bin[x, y] = hl.u8(hl.clamp(Y[x, y], 0.0, 255.0))

    eq = hl.Func("equalize")
    eq[x, y] = hl.clamp(
        cdf[hl.i32(cdf_bin[x, y])] * (255.0 / (width * height)), 0.0, 255.0)

    red = hl.u8(hl.clamp(eq[x, y] + (Cr[x, y] - 128.0) * 1.4, 0.0, 255.0))
    green = hl.u8(hl.clamp(eq[x, y] - 0.343 * (Cb[x, y] - 128.0)
                           - 0.711 * (Cr[x, y] - 128.0), 0.0, 255.0))
    blue = hl.u8(hl.clamp(eq[x, y] + 1.765 * (Cb[x, y] - 128.0), 0.0, 255.0))
    output = hl.Func("hist_out")
    output[x, y, c] = hl.mux(c, [red, green, blue])
    output.bound(c, 0, 3)

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"input": rng.integers(0, 256, (3, height, width), np.uint8)}

    def reference(input):
        a = input
        f = np.float32
        Yr = (f(0.299) * a[0].astype(f) + f(0.587) * a[1].astype(f)
              + f(0.114) * a[2].astype(f))
        Crr = (a[0].astype(f) - Yr) * f(0.713) + f(128)
        Cbr = (a[2].astype(f) - Yr) * f(0.564) + f(128)
        bins = np.clip(Yr, 0, 255).astype(np.int32)
        h = np.bincount(bins.ravel(), minlength=256).astype(np.int32)
        cdf_r = np.cumsum(h).astype(np.int32)
        lut_bin = np.clip(Yr, 0, 255).astype(np.uint8)
        eq_r = np.clip(cdf_r[lut_bin.astype(np.int32)].astype(f)
                       * f(255.0 / (width * height)), 0, 255)
        red_r = np.clip(eq_r + (Crr - 128) * f(1.4), 0, 255).astype(np.uint8)
        green_r = np.clip(eq_r - f(0.343) * (Cbr - 128)
                          - f(0.711) * (Crr - 128), 0, 255).astype(np.uint8)
        blue_r = np.clip(eq_r + f(1.765) * (Cbr - 128), 0, 255).astype(np.uint8)
        return np.stack([red_r, green_r, blue_r], axis=0)

    return App("hist", hl.Pipeline(output), [inp], make_inputs, reference,
               [width, height, 3], megapixels=width * height / 1e6,
               tolerance=0.0, atol=2.0)

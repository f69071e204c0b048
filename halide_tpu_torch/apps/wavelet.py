"""wavelet: Haar and Daubechies forward/inverse x-transforms
(reference: apps/wavelet/haar_x_generator.cpp, daubechies_x_generator.cpp,
inverse_*_generator.cpp; constants daubechies_constants.h)."""
from __future__ import annotations

import numpy as np

import halide_tpu_torch as hl

from . import App, register

D0 = 0.4829629131445341
D1 = 0.83651630373780772
D2 = 0.22414386804201339
D3 = -0.12940952255126034


def haar_x(inp):
    x, y, c = hl.Var("x"), hl.Var("y"), hl.Var("c")
    f = hl.repeat_edge(inp)
    out = hl.Func("haar_x")
    out[x, y, c] = hl.mux(c, [f[2 * x, y] + f[2 * x + 1, y],
                              f[2 * x, y] - f[2 * x + 1, y]]) / 2
    return out


def inverse_haar_x(inp):
    x, y, c = hl.Var("x"), hl.Var("y"), hl.Var("c")
    out = hl.Func("inv_haar_x")
    out[x, y, c] = hl.select(
        (x % 2) == 0,
        inp[x / 2, y, 0] + inp[x / 2, y, 1],
        inp[x / 2, y, 0] - inp[x / 2, y, 1])
    return out


def daubechies_x(inp):
    x, y, c = hl.Var("x"), hl.Var("y"), hl.Var("c")
    f = hl.repeat_edge(inp)
    out = hl.Func("daub_x")
    out[x, y, c] = hl.mux(c, [
        D0 * f[2 * x - 1, y] + D1 * f[2 * x, y]
        + D2 * f[2 * x + 1, y] + D3 * f[2 * x + 2, y],
        D3 * f[2 * x - 1, y] - D2 * f[2 * x, y]
        + D1 * f[2 * x + 1, y] - D0 * f[2 * x + 2, y]])
    return out


@register("wavelet")
def build(width: int = 1536, height: int = 2560) -> App:
    inp = hl.ImageParam(hl.Float(32), 2, "input")
    fwd = haar_x(inp)
    inv = inverse_haar_x(fwd)
    daub = daubechies_x(inp)
    # materialize the transforms: inline composition of clamp with the
    # stride-2 reads would fall off the slice fast path into gathers
    fwd.compute_root()
    inv.compute_root()
    daub.compute_root()
    x, y, c = hl.Var("x"), hl.Var("y"), hl.Var("c")
    out = hl.Func("wavelet_out")
    # roundtrip error + daubechies detail band, packed per channel
    out[x, y, c] = hl.mux(c, [fwd[hl.clamp(x, 0, width // 2 - 1), y, 0],
                              inv[x, y, 0],
                              daub[hl.clamp(x, 0, width // 2 - 1), y, 1]])

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"input": rng.random((height, width), np.float32)}

    def reference(input):
        f = np.float32
        H, W = height, width
        even, odd = input[:, 0::2], input[:, 1::2]
        low = (even + odd) / 2
        high = (even - odd) / 2
        # inverse haar
        invr = np.zeros((H, W), f)
        invr[:, 0::2] = low + high
        invr[:, 1::2] = low - high
        # daubechies detail band with repeat_edge
        p = np.pad(input, ((0, 0), (1, 2)), mode="edge")
        xm1 = p[:, 0:-3:2]
        x0 = p[:, 1:-2:2]
        x1 = p[:, 2:-1:2]
        x2 = p[:, 3::2]
        detail = (f(D3) * xm1 - f(D2) * x0 + f(D1) * x1 - f(D0) * x2)
        halfidx = np.clip(np.arange(W), 0, W // 2 - 1)
        return np.stack([low[:, halfidx], invr, detail[:, halfidx]])

    return App("wavelet", hl.Pipeline(out), [inp], make_inputs, reference,
               [width, height, 3], megapixels=width * height / 1e6,
               tolerance=1e-5, atol=1e-6)

"""conv_layer: 3x3 conv + bias + ReLU on CI=CO=128
(reference: apps/conv_layer/conv_layer_generator.cpp:14-27). The
contraction update lowers to one convolution (eval_torch.try_conv_reduce);
depthwise_separable_conv's pointwise update to an einsum above the unroll's
tap count."""
from __future__ import annotations

import numpy as np

import halide_tpu_torch as hl

from . import App, register


@register("conv_layer")
def build(N: int = 5, CI: int = 128, CO: int = 128, W: int = 100,
          H: int = 80, **_ignored) -> App:
    x, y, c, n = hl.Var("x"), hl.Var("y"), hl.Var("c"), hl.Var("n")
    inp = hl.ImageParam(hl.Float(32), 4, "input")      # (ci, x, y, n)
    filt = hl.ImageParam(hl.Float(32), 4, "filter")    # (co, kx, ky, ci)
    bias = hl.ImageParam(hl.Float(32), 1, "bias")

    r = hl.RDom(0, CI, 0, 3, 0, 3, "r")
    conv = hl.Func("conv")
    conv[c, x, y, n] = bias[c]
    conv[c, x, y, n] += filt[c, r.y, r.z, r.x] * inp[r.x, x + r.y, y + r.z, n]

    relu = hl.Func("relu")
    relu[c, x, y, n] = hl.max(0.0, conv[c, x, y, n])

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {
            "input": rng.standard_normal((N, H + 2, W + 2, CI),
                                         np.float32),
            "filter": rng.standard_normal((CI, 3, 3, CO), np.float32) * 0.1,
            "bias": rng.standard_normal(CO, np.float32),
        }

    def reference(input, filter, bias):
        # input np[n, y, x, ci]; filter np[ci, ky, kx, co]
        out = np.zeros((N, H, W, CO), np.float32)
        for ky in range(3):
            for kx in range(3):
                patch = input[:, ky:ky + H, kx:kx + W, :]
                out += np.einsum("nyxc,cd->nyxd", patch,
                                 filter[:, ky, kx, :],
                                 dtype=np.float32)
        out += bias[None, None, None, :]
        return np.maximum(out, 0.0).astype(np.float32)

    return App("conv_layer", hl.Pipeline(relu), [inp, filt, bias],
               make_inputs, reference, [CO, W, H, N],
               megapixels=W * H * N / 1e6, tolerance=1e-3, atol=1e-2,
               flops=2.0 * N * H * W * CO * CI * 9)


@register("depthwise_separable_conv")
def build_dw(N: int = 4, CI: int = 32, CO: int = 16, CM: int = 1,
             W: int = 112, H: int = 112, **_ignored) -> App:
    """depthwise + pointwise conv (reference:
    apps/depthwise_separable_conv/depthwise_separable_conv_generator.cpp)."""
    x, y, d, b = hl.Var("x"), hl.Var("y"), hl.Var("d"), hl.Var("b")
    inp = hl.ImageParam(hl.Float(32), 4, "input")            # (ci, x, y, b)
    dw_filt = hl.ImageParam(hl.Float(32), 4, "depthwise_filter")
    pw_filt = hl.ImageParam(hl.Float(32), 2, "pointwise_filter")
    bias = hl.ImageParam(hl.Float(32), 1, "bias")

    in_bounds = hl.logical_and(x >= 0, x < W, y >= 0, y < H)
    cx = hl.clamp(x, 0, W - 1)
    cy = hl.clamp(y, 0, H - 1)
    input_bounded = hl.Func("input_bounded")
    input_bounded[d, x, y, b] = hl.select(
        in_bounds, inp[d, cx, cy, b], 0.0)

    pad = 1   # 3x3 depthwise filter
    rd = hl.RDom(0, CM, 0, 3, 0, 3, "rdw")
    depthwise = hl.Func("depthwise_convolved")
    depthwise[d, x, y, b] += (
        dw_filt[rd.x, d, rd.y, rd.z]
        * input_bounded[d / CM, x + rd.y - pad, y + rd.z - pad, b])

    rc = hl.RDom(0, CI * CM, "rc")
    pointwise = hl.Func("pointwise_convolved")
    pointwise[d, x, y, b] = bias[d]
    pointwise[d, x, y, b] += pw_filt[d, rc.x] * depthwise[rc.x, x, y, b]
    # The JAX app's switch and default (chosen there by TPU measurement,
    # kept so that both packages build the same pipeline): the
    # zero-padded input and the depthwise stage stored at root
    import os
    _dw_roots = os.environ.get("HALIDE_TPU_DW_ROOTS",
                               "input_bounded,depthwise")
    _dw_by_name = {"depthwise": depthwise, "input_bounded": input_bounded}
    for _n in filter(None, _dw_roots.split(",")):
        _dw_by_name[_n].compute_root()

    output = hl.Func("dw_out")
    output[d, x, y, b] = hl.max(pointwise[d, x, y, b], 0.0)

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {
            "input": rng.standard_normal((N, H, W, CI), np.float32),
            "depthwise_filter": rng.standard_normal((3, 3, CI * CM, CM),
                                                    np.float32),
            "pointwise_filter": rng.standard_normal((CI * CM, CO),
                                                    np.float32) * 0.1,
            "bias": rng.standard_normal(CO, np.float32),
        }

    def reference(input, depthwise_filter, pointwise_filter, bias):
        # input np[b, y, x, ci]; dw np[ky, kx, d, cm]; pw np[ci, co]
        padded = np.zeros((N, H + 2, W + 2, CI), np.float32)
        padded[:, 1:H + 1, 1:W + 1, :] = input
        dwc = np.zeros((N, H, W, CI * CM), np.float32)
        for ky in range(3):
            for kx in range(3):
                for cm in range(CM):
                    w = depthwise_filter[ky, kx, :, cm]
                    src = padded[:, ky:ky + H, kx:kx + W, :]
                    dwc[..., :] += w[None, None, None, :] * src
        out = np.einsum("nyxc,cd->nyxd", dwc, pointwise_filter,
                        dtype=np.float32)
        out += bias[None, None, None, :]
        return np.maximum(out, 0.0).astype(np.float32)

    return App("depthwise_separable_conv", hl.Pipeline(output),
               [inp, dw_filt, pw_filt, bias], make_inputs, reference,
               [CO, W, H, N], megapixels=W * H * N / 1e6,
               tolerance=1e-3, atol=1e-2)

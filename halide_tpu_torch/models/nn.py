"""NN layer builders on the Func DSL (reference: apps/resnet_50
Resnet50Generator.cpp's per-block generators, apps/conv_layer). Convolutions
are written as RDom contractions, which the evaluator lowers to
convolutions (cuDNN) and einsums (cuBLAS), f32 at full precision;
everything composes with the same schedule/bounds machinery as image
pipelines.

Layout convention: feature maps are (c, x, y, n) funcs (c = lane dim);
weights (co, kx, ky, ci). The sequence builders below (`linear`,
`rms_norm`, `silu`, `softplus`) take a Func whose leading dims are the
features and whose other dims (`rest`: positions, batch) are any list of
Vars; a weight's dim 0 is its input feature, as torch's (out, in) layout
read minor-first.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

import halide_tpu_torch as hl


def conv2d(name, inp, weights, bias, ci: int, co: int, k: int,
           stride: int = 1, pad: Optional[int] = None):
    """inp: func/imageparam (c, x, y, n); weights (co, kx, ky, ci);
    bias (co). Zero-padded ("same" when stride=1 and pad=k//2)."""
    x, y, c, n = hl.Var("x"), hl.Var("y"), hl.Var("c"), hl.Var("n")
    if pad is None:
        pad = k // 2
    r = hl.RDom(0, ci, 0, k, 0, k, f"r_{name}")
    f = hl.Func(name)
    f[c, x, y, n] = bias[c]
    f[c, x, y, n] += weights[c, r.y, r.z, r.x] * \
        inp[r.x, stride * x + r.y - pad, stride * y + r.z - pad, n]
    f.compute_root()
    return f


def zero_pad(name, inp, w: int, h: int):
    """Zero boundary for conv inputs (spatial dims 1, 2)."""
    x, y, c, n = hl.Var("x"), hl.Var("y"), hl.Var("c"), hl.Var("n")
    f = hl.Func(name)
    inside = hl.logical_and(x >= 0, x < w, y >= 0, y < h)
    f[c, x, y, n] = hl.select(
        inside, inp[c, hl.clamp(x, 0, w - 1), hl.clamp(y, 0, h - 1), n], 0.0)
    # materialized so downstream convolutions see a realized array and
    # take the convolution path (eval_torch.try_conv_reduce)
    f.compute_root()
    return f


def bn_relu(name, inp, scale, shift, relu: bool = True):
    """Folded inference batchnorm: scale*x + shift (+ ReLU)."""
    x, y, c, n = hl.Var("x"), hl.Var("y"), hl.Var("c"), hl.Var("n")
    f = hl.Func(name)
    v = inp[c, x, y, n] * scale[c] + shift[c]
    f[c, x, y, n] = hl.max(v, 0.0) if relu else v
    return f


def add_relu(name, a, b):
    x, y, c, n = hl.Var("x"), hl.Var("y"), hl.Var("c"), hl.Var("n")
    f = hl.Func(name)
    f[c, x, y, n] = hl.max(a[c, x, y, n] + b[c, x, y, n], 0.0)
    return f


def max_pool(name, inp, k: int, stride: int, w: int, h: int):
    x, y, c, n = hl.Var("x"), hl.Var("y"), hl.Var("c"), hl.Var("n")
    pad = k // 2
    r = hl.RDom(0, k, 0, k, f"r_{name}")
    f = hl.Func(name)
    bounded = zero_pad(name + "_pad", inp, w, h)
    f[c, x, y, n] = hl.maximum(
        bounded[c, stride * x + r.x - pad, stride * y + r.y - pad, n])
    f.compute_root()
    return f


def global_avg_pool(name, inp, w: int, h: int):
    c, n = hl.Var("c"), hl.Var("n")
    r = hl.RDom(0, w, 0, h, f"r_{name}")
    f = hl.Func(name)
    f[c, n] = hl.sum(inp[c, r.x, r.y, n]) / float(w * h)
    f.compute_root()
    return f


def dense(name, inp, weights, bias, ci: int):
    """inp (c, n); weights (co, ci); bias (co)."""
    c, n = hl.Var("c"), hl.Var("n")
    r = hl.RDom(0, ci, f"r_{name}")
    f = hl.Func(name)
    f[c, n] = bias[c]
    f[c, n] += weights[c, r.x] * inp[r.x, n]
    f.compute_root()
    return f


def softmax(name, inp, classes: int):
    c, n = hl.Var("c"), hl.Var("n")
    r = hl.RDom(0, classes, f"r_{name}")
    mx = hl.Func(name + "_max")
    mx[n] = hl.maximum(inp[r.x, n])
    ex = hl.Func(name + "_exp")
    ex[c, n] = hl.exp(inp[c, n] - mx[n])
    s = hl.Func(name + "_sum")
    s[n] = hl.sum(ex[r.x, n])
    f = hl.Func(name)
    f[c, n] = ex[c, n] / s[n]
    return f


def silu(e):
    """x * sigmoid(x), as x / (1 + exp(-x))."""
    return e / (1.0 + hl.exp(-e))


def log1p(u):
    """log(1 + u) accurate for small u: log(v) * u / (v - 1) with v = 1 + u
    rounded (Goldberg's correction), u itself where v rounds to 1."""
    v = 1.0 + u
    return hl.select(v == 1.0, u, hl.log(v) * u / (v - 1.0))


def softplus(e, threshold: float = 20.0):
    """log(1 + exp(x)), and x itself above `threshold` (torch's
    softplus)."""
    return hl.select(e > threshold, e, log1p(hl.exp(e)))


def linear(name, w, x, n_in: int, out, rest):
    """f[*out, *rest] = sum_r w[r, *out] * x[r, *rest]: a projection, one
    einsum (cuBLAS) on the card. `n_in` is the reduced feature extent;
    `out` the Vars of the output features (more than one where the weight
    is split, e.g. (head dim, head))."""
    r = hl.RDom(0, n_in, f"r_{name}")
    f = hl.Func(name)
    f[tuple(out) + tuple(rest)] = hl.sum(
        w[(r.x,) + tuple(out)] * x[(r.x,) + tuple(rest)])
    f.compute_root()
    return f


def rms_norm(name, x, weight, width: int, eps: float, rest, lead=1,
             extents=None):
    """RMSNorm over x's leading `lead` dims (of `extents`, their product
    `width`): ss[*rest] = sum of x^2 (its own stage: one einsum on the
    card, computed once a position) and n[*feat, *rest] = x / sqrt(ss /
    width + eps) * weight[flat feature]. -> (ss, n)."""
    extents = list(extents or [width])
    r = hl.RDom([(0, e) for e in extents], f"r_{name}")
    rv = [r[i] for i in range(lead)]
    ss = hl.Func(name + "_ss")
    xr = x[tuple(rv) + tuple(rest)]
    ss[tuple(rest)] = hl.sum(xr * xr)
    ss.compute_root()
    feat = [hl.Var(f"{name}_f{i}") for i in range(lead)]
    flat, stride = feat[0], 1
    for v, e in zip(feat[1:], extents[:-1]):
        stride *= e
        flat = flat + v * stride
    n = hl.Func(name)
    n[tuple(feat) + tuple(rest)] = x[tuple(feat) + tuple(rest)] / hl.sqrt(
        ss[tuple(rest)] / float(width) + eps) * weight[flat]
    n.compute_root()
    return ss, n

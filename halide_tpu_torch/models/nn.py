"""NN layer builders on the Func DSL (reference: apps/resnet_50
Resnet50Generator.cpp's per-block generators, apps/conv_layer). Convolutions
are written as RDom contractions, which the evaluator lowers to
convolutions (cuDNN) and einsums (cuBLAS), f32 at full precision;
everything composes with the same schedule/bounds machinery as image
pipelines.

Layout convention: feature maps are (c, x, y, n) funcs (c = lane dim);
weights (co, kx, ky, ci).
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

"""ResNet-50 forward pass on the Func DSL
(reference: apps/resnet_50/Resnet50Generator.cpp — 53 conv stages, BN folded
into scale/shift, bottleneck residual blocks; weights bound as ImageParams).

Builder is parameterized so tests can run a scaled-down variant; the chip
check runs the full [3,4,6,3] x (64..2048) network at 224x224. The one
schedule that differs from the JAX package's model: each bottleneck's
middle bn_relu is computed at root, so that every conv2d takes the
convolution path.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

import halide_tpu_torch as hl

from . import nn

LAYERS50 = (3, 4, 6, 3)


class ResNetParams:
    def __init__(self, layers=LAYERS50, width: int = 64, classes: int = 1000,
                 image: int = 224, batch: int = 1):
        self.layers = layers
        self.width = width
        self.classes = classes
        self.image = image
        self.batch = batch


def _img_param(name, dims):
    return hl.ImageParam(hl.Float(32), dims, name)


def build(p: ResNetParams):
    """Returns (pipeline, params: dict name->ImageParam, meta)."""
    params: Dict[str, hl.ImageParam] = {}

    def P(name, dims):
        ip = _img_param(name, dims)
        params[name] = ip
        return ip

    inp = P("image", 4)   # (c=3, x, y, n)
    W = H = p.image

    def conv_bn(name, src, ci, co, k, stride, w, h, relu=True):
        wts = P(f"{name}_w", 4)
        b = P(f"{name}_b", 1)
        scale = P(f"{name}_s", 1)
        shift = P(f"{name}_o", 1)
        pad = k // 2
        src2 = nn.zero_pad(f"{name}_zp", src, w, h) if pad else src
        c2 = nn.conv2d(name, src2, wts, b, ci, co, k, stride, pad)
        return nn.bn_relu(f"{name}_bn", c2, scale, shift, relu)

    # stem
    cur = conv_bn("conv1", inp, 3, p.width, 7, 2, W, H)
    W, H = W // 2, H // 2
    cur = nn.max_pool("pool1", cur, 3, 2, W, H)
    W, H = W // 2, H // 2
    cur_ch = p.width

    for stage, nblocks in enumerate(p.layers):
        mid = p.width * (2 ** stage)
        out_ch = mid * 4
        for blk in range(nblocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            name = f"res{stage}_{blk}"
            identity = cur
            a = conv_bn(f"{name}_a", cur, cur_ch, mid, 1, 1, W, H)
            b2 = conv_bn(f"{name}_b", a, mid, mid, 3, stride, W, H)
            # the 1x1 conv below reads b2 unpadded: computed at root, it is
            # a realized array that the convolution path takes (inline, its
            # values would be a factor of the unrolled, dense or einsum
            # path, computed over the same points)
            b2.compute_root()
            W2, H2 = W // stride, H // stride
            c3 = conv_bn(f"{name}_c", b2, mid, out_ch, 1, 1, W2, H2,
                         relu=False)
            if stride != 1 or cur_ch != out_ch:
                identity = conv_bn(f"{name}_ds", cur, cur_ch, out_ch, 1,
                                   stride, W, H, relu=False)
            cur = nn.add_relu(f"{name}_add", c3, identity)
            cur.compute_root()
            cur_ch = out_ch
            W, H = W2, H2

    pooled = nn.global_avg_pool("avgpool", cur, W, H)
    fcw = P("fc_w", 2)
    fcb = P("fc_b", 1)
    logits = nn.dense("fc", pooled, fcw, fcb, cur_ch)
    probs = nn.softmax("softmax", logits, p.classes)

    meta = {"final_hw": (W, H), "final_ch": cur_ch}
    return hl.Pipeline(probs), params, meta


def random_weights(p: ResNetParams, seed=0) -> Dict[str, np.ndarray]:
    """np layouts: image (n,y,x,c); conv w (ci,ky,kx,co); vectors (co,)."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}

    def convw(name, ci, co, k):
        out[f"{name}_w"] = (rng.standard_normal((ci, k, k, co), np.float32)
                            * np.float32(np.sqrt(2.0 / (ci * k * k))))
        out[f"{name}_b"] = np.zeros(co, np.float32)
        out[f"{name}_s"] = (rng.random(co, np.float32) * 0.5 + 0.75)
        out[f"{name}_o"] = rng.standard_normal(co, np.float32) * 0.1

    out["image"] = rng.standard_normal(
        (p.batch, p.image, p.image, 3), np.float32)
    convw("conv1", 3, p.width, 7)
    ch = p.width
    for stage, nblocks in enumerate(p.layers):
        mid = p.width * (2 ** stage)
        out_ch = mid * 4
        for blk in range(nblocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            name = f"res{stage}_{blk}"
            convw(f"{name}_a", ch, mid, 1)
            convw(f"{name}_b", mid, mid, 3)
            convw(f"{name}_c", mid, out_ch, 1)
            if stride != 1 or ch != out_ch:
                convw(f"{name}_ds", ch, out_ch, 1)
            ch = out_ch
    out["fc_w"] = rng.standard_normal((ch, p.classes),
                                      np.float32) * np.float32(0.01)
    out["fc_b"] = np.zeros(p.classes, np.float32)
    return out


def reference(p: ResNetParams, data: Dict[str, np.ndarray],
              logits_only: bool = False) -> np.ndarray:
    """numpy golden of the same network; np activation layout (n, y, x, c).
    With `logits_only`, fc's output (n, classes) before the softmax: at the
    canonical depth the random network's softmax is one-hot to within
    1e-5, so its logits are the finer check."""
    f = np.float32

    def conv(src, name, stride, k):
        w = data[f"{name}_w"]   # (ci, ky, kx, co)
        b = data[f"{name}_b"]
        ci, _, _, co = w.shape
        n, h, wdt, _ = src.shape
        pad = k // 2
        padded = np.zeros((n, h + 2 * pad, wdt + 2 * pad, ci), f)
        padded[:, pad:pad + h, pad:pad + wdt, :] = src
        oh = (h - 1) // stride + 1
        ow = (wdt - 1) // stride + 1
        out = np.zeros((n, oh, ow, co), f)
        for ky in range(k):
            for kx in range(k):
                patch = padded[:, ky:ky + h:stride, kx:kx + wdt:stride, :]
                out += np.einsum("nyxc,cd->nyxd", patch[:, :oh, :ow, :],
                                 w[:, ky, kx, :], dtype=f)
        return out + b

    def bn_relu(src, name, relu=True):
        v = src * data[f"{name}_s"] + data[f"{name}_o"]
        return np.maximum(v, 0) if relu else v

    cur = bn_relu(conv(data["image"], "conv1", 2, 7), "conv1")
    # maxpool 3x3 stride 2, same-pad, -inf exterior is zero-pad in our DSL
    n, h, wdt, c = cur.shape
    pad = 1
    padded = np.zeros((n, h + 2, wdt + 2, c), f)
    padded[:, 1:1 + h, 1:1 + wdt, :] = cur
    oh, ow = h // 2, wdt // 2
    pooled = np.full((n, oh, ow, c), -np.inf, f)
    for ky in range(3):
        for kx in range(3):
            pooled = np.maximum(
                pooled, padded[:, ky:ky + h:2, kx:kx + wdt:2, :][:, :oh, :ow])
    cur = pooled
    ch = p.width
    for stage, nblocks in enumerate(p.layers):
        mid = p.width * (2 ** stage)
        out_ch = mid * 4
        for blk in range(nblocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            name = f"res{stage}_{blk}"
            identity = cur
            a = bn_relu(conv(cur, f"{name}_a", 1, 1), f"{name}_a")
            b2 = bn_relu(conv(a, f"{name}_b", stride, 3), f"{name}_b")
            c3 = bn_relu(conv(b2, f"{name}_c", 1, 1), f"{name}_c",
                         relu=False)
            if stride != 1 or ch != out_ch:
                identity = bn_relu(conv(cur, f"{name}_ds", stride, 1),
                                   f"{name}_ds", relu=False)
            cur = np.maximum(c3 + identity, 0)
            ch = out_ch
    pooled = cur.mean(axis=(1, 2))                       # (n, c)
    logits = pooled @ data["fc_w"] + data["fc_b"]        # (n, classes)
    if logits_only:
        return logits.astype(f)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(f)

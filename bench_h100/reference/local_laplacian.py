"""Plain PyTorch reference of local_laplacian (Paris, Hasinoff, Kautz,
"Local Laplacian Filters", SIGGRAPH 2011; Halide's
apps/local_laplacian/local_laplacian_generator.cpp), the same arithmetic
as the app's numpy golden, frozen here.

The golden evaluates every pyramid level again over the box each consumer
needs; a level's value at a point does not depend on the box, so this
computes each level once, whole-array, over the union of the boxes its
consumers need (Halide's bounds: a downsample at [lo, hi] reads its input
at [2 lo - 1, 2 hi + 2], an upsample at [floor((lo - 1) / 2),
floor((hi + 1) / 2)]). Only the input is clamped to its edge, as in the
generator. The remap's exp is taken in float64 and rounded to the level
type. Every division is by a tensor on the input's device: PyTorch on
CUDA divides by a Python number as a multiply by its reciprocal, which
rounds otherwise than the golden's (and Halide's) division. `dtype` is the
type of every level; the configuration states float32 (the lower-precision
control passes bfloat16).

Imports nothing of the program under test.
"""
from __future__ import annotations


import numpy as np
import torch

from bench_h100.u16 import from_i32, to_i32


def _down_box(lo, hi):
    return 2 * lo - 1, 2 * hi + 2


def _up_box(lo, hi):
    return (lo - 1) // 2, (hi + 1) // 2


class _Level:
    """Values over [x0, x0 + w) x [y0, y0 + h), tensor [..., y, x]."""

    def __init__(self, t, x0, y0):
        self.t, self.x0, self.y0 = t, x0, y0

    def box(self, xlo, xhi, ylo, yhi):
        ox, oy = xlo - self.x0, ylo - self.y0
        assert ox >= 0 and oy >= 0
        assert ox + xhi - xlo < self.t.shape[-1]
        assert oy + yhi - ylo < self.t.shape[-2]
        return self.t[..., oy:oy + yhi - ylo + 1, ox:ox + xhi - xlo + 1]


def _down(lv: _Level, xlo, xhi, ylo, yhi) -> _Level:
    """((a + 3 (b + c)) + d) / 8 along y, then along x, as the golden."""
    pxlo, pxhi = _down_box(xlo, xhi)
    pylo, pyhi = _down_box(ylo, yhi)
    p = lv.box(pxlo, pxhi, pylo, pyhi)
    ny, nx = yhi - ylo + 1, xhi - xlo + 1

    def sy(k):
        return p[..., k:k + 2 * ny - 1:2, :]
    eight = torch.tensor(8.0, dtype=p.dtype, device=p.device)
    dy = (sy(0) + 3.0 * (sy(1) + sy(2)) + sy(3)) / eight

    def sx(k):
        return dy[..., k:k + 2 * nx - 1:2]
    return _Level((sx(0) + 3.0 * (sx(1) + sx(2)) + sx(3)) / eight, xlo, ylo)


def _up(lv: _Level, xlo, xhi, ylo, yhi) -> torch.Tensor:
    """a + w (b - a) with a at (x + 1) / 2 and b at (x - 1) / 2, w = 1/4 or
    3/4, along x, then along y, as the golden."""
    pxlo, pxhi = _up_box(xlo, xhi)
    pylo, pyhi = _up_box(ylo, yhi)
    p = lv.box(pxlo, pxhi, pylo, pyhi)
    dev, dt = p.device, p.dtype
    xs = torch.arange(xlo, xhi + 1, device=dev)
    ys = torch.arange(ylo, yhi + 1, device=dev)
    wx = (((xs % 2) * 2 + 1).to(torch.float64) * 0.25).to(dt)
    wy = (((ys % 2) * 2 + 1).to(torch.float64) * 0.25).to(dt)
    a = p.index_select(-1, torch.div(xs + 1, 2, rounding_mode="floor") - pxlo)
    b = p.index_select(-1, torch.div(xs - 1, 2, rounding_mode="floor") - pxlo)
    ux = a + wx * (b - a)
    del a, b
    a = ux.index_select(-2, torch.div(ys + 1, 2, rounding_mode="floor") - pylo)
    b = ux.index_select(-2, torch.div(ys - 1, 2, rounding_mode="floor") - pylo)
    return a + wy[:, None] * (b - a)


def reference(inputs: dict, args: dict, dtype=torch.float32) -> torch.Tensor:
    """inputs["input"]: uint16 [3, H, W]; -> uint16 [3, H, W]."""
    inp = inputs["input"]
    _, H, W = inp.shape
    J, L = int(args["pyramid_levels"]), int(args["levels"])
    alpha, beta = float(args["alpha"]), float(args["beta"])
    dev = inp.device

    def c(v):   # a constant of the level type, as the golden's f(v)
        return torch.tensor(v, dtype=torch.float32).to(dtype).item() \
            if dtype != torch.float32 else float(np.float32(v))

    # the boxes (x and y alike): O_j of outG, outL and lP at level j;
    # G_j of gP, N_j of inG, each the union over its consumers
    ox = [(0, W - 1)]
    oy = [(0, H - 1)]
    for _ in range(1, J):
        ox.append(_up_box(*ox[-1]))
        oy.append(_up_box(*oy[-1]))
    gx, gy = [None] * J, [None] * J
    gx[J - 1], gy[J - 1] = ox[J - 1], oy[J - 1]
    for j in range(J - 2, -1, -1):
        dx, dyb = _down_box(*gx[j + 1]), _down_box(*gy[j + 1])
        gx[j] = (min(ox[j][0], dx[0]), max(ox[j][1], dx[1]))
        gy[j] = (min(oy[j][0], dyb[0]), max(oy[j][1], dyb[1]))

    # gray over G_0 (N_0 is the same box: inG's chain is gP's), the input
    # clamped to its edge
    xs = torch.arange(gx[0][0], gx[0][1] + 1, device=dev).clamp(0, W - 1)
    ys = torch.arange(gy[0][0], gy[0][1] + 1, device=dev).clamp(0, H - 1)
    rgb = to_i32(inp).index_select(1, ys).index_select(2, xs)
    f = rgb.to(torch.float32) if dtype == torch.float32 else rgb.to(dtype)
    f = f / torch.tensor(c(65535.0), dtype=f.dtype, device=dev)
    del rgb
    gray = c(0.299) * f[0] + c(0.587) * f[1] + c(0.114) * f[2]
    del f

    # remap over the integer arguments [-256 (L - 1), 256 (L - 1)]
    n = 256 * (L - 1)
    i = np.arange(-n, n + 1)
    fx = (i.astype(np.float32) / np.float32(256.0))
    arg = -fx * fx / np.float32(2.0)
    e = torch.from_numpy(np.exp(arg.astype(np.float64))).to(dtype)
    fxt = torch.from_numpy(fx).to(dtype)
    remap = (c(alpha) * fxt * e).to(dev)

    # gPyramid[0], [k, y, x]
    ks = torch.arange(L, device=dev)
    lev = ks.to(dtype) * c(1.0 / (L - 1))
    idx = (gray * c(float(L - 1)) * c(256.0)).to(torch.int32) \
        .clamp(0, (L - 1) * 256)
    g0 = gray[None]
    gP0 = (c(beta) * (g0 - lev[:, None, None]) + lev[:, None, None]
           + remap[idx[None] - 256 * ks[:, None, None].to(torch.int32) + n])
    del idx
    gP = [_Level(gP0, gx[0][0], gy[0][0])]
    inG = [_Level(gray, gx[0][0], gy[0][0])]
    for j in range(1, J):
        gP.append(_down(gP[-1], *gx[j], *gy[j]))
        inG.append(_down(inG[-1], *gx[j], *gy[j]))

    def outL(j):
        box = (*ox[j], *oy[j])
        lp = gP[j].box(*box)
        if j < J - 1:
            lp = lp - _up(gP[j + 1], *box)
        lvl = inG[j].box(*box) * c(float(L - 1))
        li = lvl.to(torch.int32).clamp(0, L - 2)
        lf = lvl - li.to(dtype)
        a = lp.gather(0, li[None].long())[0]
        b = lp.gather(0, (li + 1)[None].long())[0]
        return (c(1.0) - lf) * a + lf * b

    outG = _Level(outL(J - 1), ox[J - 1][0], oy[J - 1][0])
    for j in range(J - 2, -1, -1):
        box = (*ox[j], *oy[j])
        outG = _Level(_up(outG, *box) + outL(j), ox[j][0], oy[j][0])
    og0 = outG.t
    g = inG[0].box(0, W - 1, 0, H - 1)
    del gP, inG
    src = to_i32(inp)
    src = src.to(torch.float32) if dtype == torch.float32 else src.to(dtype)
    col = src * (og0 + c(0.01))[None] / (g + c(0.01))[None]
    out = col.clamp(0.0, 65535.0)
    return from_i32(out.to(torch.int32))

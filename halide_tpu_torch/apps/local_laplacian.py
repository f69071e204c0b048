"""local_laplacian: K-level Gaussian/Laplacian pyramids with remap LUT
(reference: apps/local_laplacian/local_laplacian_generator.cpp:18-90,
downsample/upsample @267-282).

Two schedules, chosen by `tile`:
- a tile (the default, 256x64 where the sizes divide): the output tiled,
  outGPyramid[0] and the 8-plane lPyramid[0] computed at its tiles, so all
  the full-resolution work goes through the stencil-group kernel, which
  stages gPyramid[1] and outGPyramid[1] as div-indexed (d = 2 on x and y)
  windows for the upsamples;
- `tile=None`: outGPyramid[0] computed at root, whole-array.

The half-resolution levels are computed at root, whole-array, in both.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import halide_tpu_torch as hl

from . import App, register

_AUTO = "auto"


def _downsample(f, vars_):
    x, y = vars_[0], vars_[1]
    rest = tuple(vars_[2:])
    downy = hl.Func(f.name + "_dy")
    downx = hl.Func(f.name + "_dx")
    downy[vars_] = (f[(x, 2 * y - 1) + rest]
                    + 3.0 * (f[(x, 2 * y) + rest] + f[(x, 2 * y + 1) + rest])
                    + f[(x, 2 * y + 2) + rest]) / 8.0
    downx[vars_] = (downy[(2 * x - 1, y) + rest]
                    + 3.0 * (downy[(2 * x, y) + rest]
                             + downy[(2 * x + 1, y) + rest])
                    + downy[(2 * x + 2, y) + rest]) / 8.0
    downy.compute_root()
    return downx


def _upsample(f, vars_):
    x, y = vars_[0], vars_[1]
    rest = tuple(vars_[2:])
    upx = hl.Func(f.name + "_ux")
    upy = hl.Func(f.name + "_uy")
    upx[vars_] = hl.lerp(f[((x + 1) / 2, y) + rest],
                         f[((x - 1) / 2, y) + rest],
                         ((x % 2) * 2 + 1) / 4.0)
    upy[vars_] = hl.lerp(upx[(x, (y + 1) / 2) + rest],
                         upx[(x, (y - 1) / 2) + rest],
                         ((y % 2) * 2 + 1) / 4.0)
    return upy


@register("local_laplacian")
def build(width: int = 1536, height: int = 2560, pyramid_levels: int = 8,
          levels: int = 8, alpha: float = 1.0, beta: float = 1.0,
          tile: Optional[Tuple[int, int]] = _AUTO) -> App:
    if tile == _AUTO:
        tile = (256, 64) if width % 256 == 0 and height % 64 == 0 else None
    x, y, c, k = hl.Var("x"), hl.Var("y"), hl.Var("c"), hl.Var("k")
    inp = hl.ImageParam(hl.UInt(16), 3, "input")
    J = pyramid_levels

    remap = hl.Func("remap")
    fx = hl.f32(x) / 256.0
    remap[x] = alpha * fx * hl.exp(-fx * fx / 2.0)
    remap.compute_inline()

    clamped = hl.repeat_edge(inp)
    floating = hl.Func("floating")
    floating[x, y, c] = clamped[x, y, c] / 65535.0
    gray = hl.Func("gray")
    gray[x, y] = (0.299 * floating[x, y, 0] + 0.587 * floating[x, y, 1]
                  + 0.114 * floating[x, y, 2])
    gray.compute_root()

    gPyramid = [hl.Func(f"gPyramid_{j}") for j in range(J)]
    level = k * (1.0 / (levels - 1))
    idx = gray[x, y] * float(levels - 1) * 256.0
    idx = hl.clamp(hl.i32(idx), 0, (levels - 1) * 256)
    gPyramid[0][x, y, k] = (beta * (gray[x, y] - level) + level
                            + remap[idx - 256 * k])
    for j in range(1, J):
        gPyramid[j][x, y, k] = _downsample(gPyramid[j - 1], (x, y, k))[x, y, k]
    for f in gPyramid:
        f.compute_root()

    lPyramid = [hl.Func(f"lPyramid_{j}") for j in range(J)]
    lPyramid[J - 1][x, y, k] = gPyramid[J - 1][x, y, k]
    for j in range(J - 2, -1, -1):
        lPyramid[j][x, y, k] = (gPyramid[j][x, y, k]
                                - _upsample(gPyramid[j + 1], (x, y, k))[x, y, k])

    inGPyramid = [hl.Func(f"inGPyramid_{j}") for j in range(J)]
    inGPyramid[0][x, y] = gray[x, y]
    for j in range(1, J):
        inGPyramid[j][x, y] = _downsample(inGPyramid[j - 1], (x, y))[x, y]
    for f in inGPyramid:
        f.compute_root()

    outLPyramid = [hl.Func(f"outLPyramid_{j}") for j in range(J)]
    for j in range(J):
        lev = inGPyramid[j][x, y] * float(levels - 1)
        li = hl.clamp(hl.i32(lev), 0, levels - 2)
        lf = lev - hl.f32(li)
        outLPyramid[j][x, y] = ((1.0 - lf) * lPyramid[j][x, y, li]
                                + lf * lPyramid[j][x, y, li + 1])

    outGPyramid = [hl.Func(f"outGPyramid_{j}") for j in range(J)]
    outGPyramid[J - 1][x, y] = outLPyramid[J - 1][x, y]
    for j in range(J - 2, -1, -1):
        outGPyramid[j][x, y] = (_upsample(outGPyramid[j + 1], (x, y))[x, y]
                                + outLPyramid[j][x, y])
    for f in outGPyramid[1:]:
        f.compute_root()

    color = hl.Func("color")
    eps = 0.01
    color[x, y, c] = (inp[x, y, c] * (outGPyramid[0][x, y] + eps)
                      / (gray[x, y] + eps))

    output = hl.Func("ll_out")
    output[x, y, c] = hl.u16(hl.clamp(color[x, y, c], 0.0, 65535.0))

    if tile is not None:
        xo, yo, xin, yin = (hl.Var("xo"), hl.Var("yo"),
                            hl.Var("xin"), hl.Var("yin"))
        output.tile(x, y, xo, yo, xin, yin, tile[0], tile[1]) \
              .vectorize(xin).parallel(yo)
        outGPyramid[0].compute_at(output, xo)
        lPyramid[0].compute_at(output, xo)
    else:
        outGPyramid[0].compute_root()

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"input": rng.integers(0, 1 << 16, (3, height, width),
                                      np.uint16)}

    def reference(input):
        f = np.float32
        fdiv = np.floor_divide
        gray_full = (f(0.299) * (input[0] / f(65535))
                     + f(0.587) * (input[1] / f(65535))
                     + f(0.114) * (input[2] / f(65535))).astype(f)

        def remap_f(i):
            fx_ = i.astype(f) / f(256.0)
            return f(alpha) * fx_ * np.exp(-fx_ * fx_ / f(2.0))

        def gray_at(xlo, xhi, ylo, yhi):
            xs = np.clip(np.arange(xlo, xhi + 1), 0, width - 1)
            ys = np.clip(np.arange(ylo, yhi + 1), 0, height - 1)
            return gray_full[ys[:, None], xs[None, :]]

        def down(fn, xlo, xhi, ylo, yhi):
            """downsample: fn evaluates the previous level over a box."""
            pylo, pyhi = 2 * ylo - 1, 2 * yhi + 2
            pxlo, pxhi = 2 * xlo - 1, 2 * xhi + 2
            prev = fn(pxlo, pxhi, pylo, pyhi)

            def sly(i):
                return slice(i - pylo, i - pylo + 2 * (yhi - ylo) + 1, 2)

            dy = (prev[..., sly(2 * ylo - 1), :]
                  + f(3.0) * (prev[..., sly(2 * ylo), :]
                              + prev[..., sly(2 * ylo + 1), :])
                  + prev[..., sly(2 * ylo + 2), :]) / f(8.0)

            def slx(i):
                return slice(i - pxlo, i - pxlo + 2 * (xhi - xlo) + 1, 2)

            return (dy[..., slx(2 * xlo - 1)]
                    + f(3.0) * (dy[..., slx(2 * xlo)]
                                + dy[..., slx(2 * xlo + 1)])
                    + dy[..., slx(2 * xlo + 2)]) / f(8.0)

        def up(fn, xlo, xhi, ylo, yhi):
            pxlo, pxhi = fdiv(xlo - 1, 2), fdiv(xhi + 1, 2)
            pylo, pyhi = fdiv(ylo - 1, 2), fdiv(yhi + 1, 2)
            prev = fn(pxlo, pxhi, pylo, pyhi)
            xs = np.arange(xlo, xhi + 1)
            ys = np.arange(ylo, yhi + 1)
            wx = (((xs % 2) * 2 + 1) / 4.0).astype(f)
            wy = (((ys % 2) * 2 + 1) / 4.0).astype(f)
            a = prev[..., fdiv(xs + 1, 2) - pxlo]
            b = prev[..., fdiv(xs - 1, 2) - pxlo]
            ux = a + wx * (b - a)
            a2 = ux[..., fdiv(ys + 1, 2) - pylo, :]
            b2 = ux[..., fdiv(ys - 1, 2) - pylo, :]
            return a2 + wy[:, None] * (b2 - a2)

        def gP(j, xlo, xhi, ylo, yhi):
            if j == 0:
                g = gray_at(xlo, xhi, ylo, yhi)[None]       # [k, y, x]
                ks = np.arange(levels).astype(f)[:, None, None]
                lev = ks * f(1.0 / (levels - 1))
                idx_ = np.clip((g * f(levels - 1) * f(256)).astype(np.int32),
                               0, (levels - 1) * 256)
                return (f(beta) * (g - lev) + lev
                        + remap_f(idx_ - 256 * ks.astype(np.int32)))
            return down(lambda a, b, c2, d: gP(j - 1, a, b, c2, d),
                        xlo, xhi, ylo, yhi)

        def inG(j, xlo, xhi, ylo, yhi):
            if j == 0:
                return gray_at(xlo, xhi, ylo, yhi)
            return down(lambda a, b, c2, d: inG(j - 1, a, b, c2, d),
                        xlo, xhi, ylo, yhi)

        def lP(j, xlo, xhi, ylo, yhi):
            g = gP(j, xlo, xhi, ylo, yhi)
            if j == J - 1:
                return g
            u = up(lambda a, b, c2, d: gP(j + 1, a, b, c2, d),
                   xlo, xhi, ylo, yhi)
            return g - u

        def outL(j, xlo, xhi, ylo, yhi):
            ing = inG(j, xlo, xhi, ylo, yhi)
            lp = lP(j, xlo, xhi, ylo, yhi)
            lev = ing * f(levels - 1)
            li = np.clip(lev.astype(np.int32), 0, levels - 2)
            lf = lev - li.astype(f)
            iy, ix = np.meshgrid(np.arange(li.shape[0]),
                                 np.arange(li.shape[1]), indexing="ij")
            return ((f(1.0) - lf) * lp[li, iy, ix]
                    + lf * lp[li + 1, iy, ix])

        def outG(j, xlo, xhi, ylo, yhi):
            ol = outL(j, xlo, xhi, ylo, yhi)
            if j == J - 1:
                return ol
            u = up(lambda a, b, c2, d: outG(j + 1, a, b, c2, d),
                   xlo, xhi, ylo, yhi)
            return u + ol

        og0 = outG(0, 0, width - 1, 0, height - 1)
        col = (input.astype(f) * (og0 + f(0.01))[None]
               / (gray_full + f(0.01))[None])
        return np.clip(col, 0, 65535).astype(np.uint16)

    return App("local_laplacian", hl.Pipeline(output), [inp], make_inputs,
               reference, [width, height, 3],
               megapixels=width * height / 1e6, tolerance=0.0, atol=2.0,
               mismatch_frac=0.003)

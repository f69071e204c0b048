"""interpolate: alpha-weighted pyramid upsample/downsample interpolation
(reference: apps/interpolate/interpolate_generator.cpp:20-73).

Two schedules, chosen by `tile`:
- a tile (the default, 256x64 where the sizes divide): normalize tiled,
  interpolated[0] computed at its tiles, so the full-resolution blend and
  normalize go through the stencil-group kernel, which stages
  interpolated[1] as a div-indexed (d = 2 on x and y) window;
- `tile=None`: interpolated[0] computed at root, whole-array.

The coarser levels are computed at root, whole-array, in both.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import halide_tpu_torch as hl

from . import App, register

_AUTO = "auto"


@register("interpolate")
def build(width: int = 1536, height: int = 2560, levels: int = 10,
          tile: Optional[Tuple[int, int]] = _AUTO) -> App:
    if tile == _AUTO:
        tile = (256, 64) if width % 256 == 0 and height % 64 == 0 else None
    x, y, c = hl.Var("x"), hl.Var("y"), hl.Var("c")
    inp = hl.ImageParam(hl.Float(32), 3, "input")   # rgba

    clamped = hl.repeat_edge(inp)

    downsampled = [hl.Func(f"downsampled_{i}") for i in range(levels)]
    downx = [hl.Func(f"downx_{i}") for i in range(levels)]
    interpolated = [hl.Func(f"interp_{i}") for i in range(levels)]
    upsampled = [hl.Func(f"upsampled_{i}") for i in range(levels)]
    upsampledx = [hl.Func(f"upsampledx_{i}") for i in range(levels)]

    downsampled[0][x, y, c] = hl.select(
        c < 3, clamped[x, y, c] * clamped[x, y, 3], clamped[x, y, 3])

    for l in range(1, levels):
        prev = downsampled[l - 1]
        if l == 4:
            w = width // (1 << (l - 1))
            h = height // (1 << (l - 1))
            bounded = hl.Func(f"bounded_{l}")
            bounded[x, y, c] = prev[hl.clamp(x, 0, w), hl.clamp(y, 0, h), c]
            prev = bounded
        downx[l][x, y, c] = (prev[x * 2 - 1, y, c]
                             + 2.0 * prev[x * 2, y, c]
                             + prev[x * 2 + 1, y, c]) * 0.25
        downsampled[l][x, y, c] = (downx[l][x, y * 2 - 1, c]
                                   + 2.0 * downx[l][x, y * 2, c]
                                   + downx[l][x, y * 2 + 1, c]) * 0.25
        downx[l].compute_root()
        downsampled[l].compute_root()

    interpolated[levels - 1][x, y, c] = downsampled[levels - 1][x, y, c]
    for l in range(levels - 2, -1, -1):
        upsampledx[l][x, y, c] = (interpolated[l + 1][x / 2, y, c]
                                  + interpolated[l + 1][(x + 1) / 2, y, c]) \
            / 2.0
        upsampled[l][x, y, c] = (upsampledx[l][x, y / 2, c]
                                 + upsampledx[l][x, (y + 1) / 2, c]) / 2.0
        alpha = 1.0 - downsampled[l][x, y, 3]
        interpolated[l][x, y, c] = (downsampled[l][x, y, c]
                                    + alpha * upsampled[l][x, y, c])
        if l > 0:
            interpolated[l].compute_root()

    normalize = hl.Func("normalize")
    normalize[x, y, c] = interpolated[0][x, y, c] / interpolated[0][x, y, 3]

    if tile is not None:
        xo, yo, xin, yin = (hl.Var("xo"), hl.Var("yo"),
                            hl.Var("xin"), hl.Var("yin"))
        normalize.tile(x, y, xo, yo, xin, yin, tile[0], tile[1]) \
                 .vectorize(xin).parallel(yo)
        interpolated[0].compute_at(normalize, xo)
    else:
        interpolated[0].compute_root()

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        a = rng.random((4, height, width), np.float32)
        a[3] = rng.random((height, width), np.float32) * 0.9 + 0.05
        return {"input": a}

    def reference(input):
        f = np.float32
        fdiv = np.floor_divide

        def down_level(l, xlo, xhi, ylo, yhi):
            """downsampled[l] over the inclusive box; np[c, y, x]."""
            if l == 0:
                xs = np.clip(np.arange(xlo, xhi + 1), 0, width - 1)
                ys = np.clip(np.arange(ylo, yhi + 1), 0, height - 1)
                base = input[:, ys[:, None], xs[None, :]].astype(f)
                out = np.empty_like(base)
                out[:3] = base[:3] * base[3]
                out[3] = base[3]
                return out
            pxlo, pxhi = 2 * xlo - 1, 2 * xhi + 1
            pylo, pyhi = 2 * ylo - 1, 2 * yhi + 1
            prev = down_level(l - 1, pxlo, pxhi, pylo, pyhi)
            if l == 4:
                w4 = width // (1 << (l - 1))
                h4 = height // (1 << (l - 1))
                xs = np.clip(np.arange(pxlo, pxhi + 1), 0, w4)
                ys = np.clip(np.arange(pylo, pyhi + 1), 0, h4)
                prev = down_level(l - 1, xs.min(), xs.max(),
                                  ys.min(), ys.max())
                prev = prev[:, (ys - ys.min())[:, None],
                            (xs - xs.min())[None, :]]

            def px(i):   # prev x-index offset
                return slice(i - pxlo, i - pxlo + 2 * (xhi - xlo) + 1, 2)
            dx_a = (prev[:, :, px(2 * xlo - 1)]
                    + f(2.0) * prev[:, :, px(2 * xlo)]
                    + prev[:, :, px(2 * xlo + 1)]) * f(0.25)

            def py(i):
                return slice(i - pylo, i - pylo + 2 * (yhi - ylo) + 1, 2)
            return (dx_a[:, py(2 * ylo - 1), :]
                    + f(2.0) * dx_a[:, py(2 * ylo), :]
                    + dx_a[:, py(2 * ylo + 1), :]) * f(0.25)

        def interp_level(l, xlo, xhi, ylo, yhi):
            if l == levels - 1:
                return down_level(l, xlo, xhi, ylo, yhi)
            uxlo, uxhi = fdiv(xlo, 2), fdiv(xhi + 1, 2)
            uylo, uyhi = fdiv(ylo, 2), fdiv(yhi + 1, 2)
            nxt = interp_level(l + 1, uxlo, uxhi, uylo, uyhi)
            xs = np.arange(xlo, xhi + 1)
            ys = np.arange(ylo, yhi + 1)
            ux = (nxt[:, :, fdiv(xs, 2) - uxlo]
                  + nxt[:, :, fdiv(xs + 1, 2) - uxlo]) * f(0.5)
            up = (ux[:, fdiv(ys, 2) - uylo, :]
                  + ux[:, fdiv(ys + 1, 2) - uylo, :]) * f(0.5)
            dsl = down_level(l, xlo, xhi, ylo, yhi)
            return dsl + (f(1.0) - dsl[3]) * up

        a0 = interp_level(0, 0, width - 1, 0, height - 1)
        return (a0[:3] / a0[3]).astype(f)

    return App("interpolate", hl.Pipeline(normalize), [inp], make_inputs,
               reference, [width, height, 3], tolerance=2e-3, atol=2e-3,
               megapixels=width * height / 1e6)

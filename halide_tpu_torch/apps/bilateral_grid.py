"""bilateral_grid: grid construction (scatter) + 3 blur passes + trilinear
slice (reference: apps/bilateral_grid/bilateral_grid_generator.cpp:14-69)."""
from __future__ import annotations

import numpy as np

import halide_tpu_torch as hl

from . import App, register


@register("bilateral_grid")
def build(width: int = 1536, height: int = 2560, s_sigma: int = 8,
          r_sigma: float = 0.1, tile=(512, 256)) -> App:
    x, y, z, c = hl.Var("x"), hl.Var("y"), hl.Var("z"), hl.Var("c")
    inp = hl.ImageParam(hl.Float(32), 2, "input")

    clamped = hl.repeat_edge(inp)

    r = hl.RDom(0, s_sigma, 0, s_sigma, "r")
    val = clamped[x * s_sigma + r.x - s_sigma // 2,
                  y * s_sigma + r.y - s_sigma // 2]
    val = hl.clamp(val, 0.0, 1.0)
    zi = hl.i32(val * (1.0 / r_sigma) + 0.5)

    histogram = hl.Func("histogram")
    histogram[x, y, z, c] = 0.0
    histogram[x, y, zi, c] += hl.mux(c, [val, hl.f32(1.0)])
    histogram.compute_root()

    blurz = hl.Func("blurz")
    blurz[x, y, z, c] = (histogram[x, y, z - 2, c]
                         + histogram[x, y, z - 1, c] * 4
                         + histogram[x, y, z, c] * 6
                         + histogram[x, y, z + 1, c] * 4
                         + histogram[x, y, z + 2, c])
    blurx = hl.Func("blurx")
    blurx[x, y, z, c] = (blurz[x - 2, y, z, c]
                         + blurz[x - 1, y, z, c] * 4
                         + blurz[x, y, z, c] * 6
                         + blurz[x + 1, y, z, c] * 4
                         + blurz[x + 2, y, z, c])
    blury = hl.Func("blury")
    blury[x, y, z, c] = (blurx[x, y - 2, z, c]
                         + blurx[x, y - 1, z, c] * 4
                         + blurx[x, y, z, c] * 6
                         + blurx[x, y + 1, z, c] * 4
                         + blurx[x, y + 2, z, c])
    blurz.compute_root()
    blury.compute_root()

    val2 = hl.clamp(inp[x, y], 0.0, 1.0)
    zv = val2 * (1.0 / r_sigma)
    zi2 = hl.i32(zv)
    zf = zv - zi2
    xf = hl.f32(x % s_sigma) / s_sigma
    yf = hl.f32(y % s_sigma) / s_sigma
    xi = x / s_sigma
    yi = y / s_sigma

    def B(dx, dy, dz):
        return blury[xi + dx, yi + dy, zi2 + dz, c]

    interpolated = hl.Func("interpolated")
    interpolated[x, y, c] = hl.lerp(
        hl.lerp(hl.lerp(B(0, 0, 0), B(1, 0, 0), xf),
                hl.lerp(B(0, 1, 0), B(1, 1, 0), xf), yf),
        hl.lerp(hl.lerp(B(0, 0, 1), B(1, 0, 1), xf),
                hl.lerp(B(0, 1, 1), B(1, 1, 1), xf), yf),
        zf)

    output = hl.Func("bilateral_out")
    output[x, y] = interpolated[x, y, 0] / interpolated[x, y, 1]

    # schedule (reference: apps/bilateral_grid/bilateral_grid_generator.cpp:
    # 86-123, whose GPU schedule also tiles the slice with blury staged):
    # the trilinear slice is the only full-resolution stage, so it is one
    # stencil-group kernel over tiles of the output (512x256 where the
    # sizes divide, the JAX app's default), blury staged as a window with
    # x / 8 and y / 8 div-indexed dims and a static z dim that holds every
    # plane the data-dependent zi2 can reach. The grid construction and
    # the blurs are whole-array. tile=None computes the slice at root.
    if tile is not None and width % tile[0] == 0 and height % tile[1] == 0:
        xo, yo, xin, yin = (hl.Var("xo"), hl.Var("yo"),
                            hl.Var("xin"), hl.Var("yin"))
        output.tile(x, y, xo, yo, xin, yin, tile[0], tile[1]) \
              .vectorize(xin).parallel(yo)
        interpolated.compute_at(output, xo)
    else:
        interpolated.compute_root()

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"input": rng.random((height, width), np.float32)}

    def reference(input):
        f = np.float32
        s = s_sigma
        inv = f(1.0 / r_sigma)
        zmax = int(np.float32(1.0) * inv + 0.5)
        # grid ranges with the stencil margins
        x0, x1 = -2, (width - 1) // s + 1 + 2
        y0, y1 = -2, (height - 1) // s + 1 + 2
        z0, z1 = -2, zmax + 1 + 2
        gw, gh, gz = x1 - x0 + 1, y1 - y0 + 1, z1 - z0 + 1
        hist = np.zeros((2, gz, gh, gw), f)
        gx = np.arange(x0, x1 + 1)
        gy = np.arange(y0, y1 + 1)
        for ry in range(s):
            py = np.clip(gy * s + ry - s // 2, 0, height - 1)
            for rx in range(s):
                px = np.clip(gx * s + rx - s // 2, 0, width - 1)
                v = np.clip(input[py[:, None], px[None, :]], 0, 1).astype(f)
                ziv = (v * inv + f(0.5)).astype(np.int32)
                iy, ix = np.meshgrid(np.arange(gh), np.arange(gw),
                                     indexing="ij")
                np.add.at(hist[0], (ziv - z0, iy, ix), v)
                np.add.at(hist[1], (ziv - z0, iy, ix), f(1.0))

        def blur5(a, axis):
            k = [1, 4, 6, 4, 1]
            out = np.zeros_like(a)
            pad = [(0, 0)] * a.ndim
            pad[axis] = (2, 2)
            ap = np.pad(a, pad, mode="constant")
            n = a.shape[axis]
            for i, kv in enumerate(k):
                sl = [slice(None)] * a.ndim
                sl[axis] = slice(i, i + n)
                out += f(kv) * ap[tuple(sl)]
            return out

        g = blur5(blur5(blur5(hist, 1), 3), 2)   # z, x, y

        xs = np.arange(width)
        ys = np.arange(height)
        v2 = np.clip(input, 0, 1).astype(f)
        zvv = v2 * inv
        zi2v = zvv.astype(np.int32)
        zfv = zvv - zi2v
        xfv = f(1.0 / s) * (xs % s).astype(f)
        yfv = f(1.0 / s) * (ys % s).astype(f)
        xiv = xs // s - x0
        yiv = ys // s - y0
        ziv2 = zi2v - z0

        def samp(dx, dy, dz, chan):
            return g[chan][ziv2 + dz, (yiv[:, None] + dy), (xiv[None, :] + dx)]

        out_c = []
        for chan in (0, 1):
            l00 = samp(0, 0, 0, chan) + xfv[None, :] * (
                samp(1, 0, 0, chan) - samp(0, 0, 0, chan))
            l10 = samp(0, 1, 0, chan) + xfv[None, :] * (
                samp(1, 1, 0, chan) - samp(0, 1, 0, chan))
            l0 = l00 + yfv[:, None] * (l10 - l00)
            l01 = samp(0, 0, 1, chan) + xfv[None, :] * (
                samp(1, 0, 1, chan) - samp(0, 0, 1, chan))
            l11 = samp(0, 1, 1, chan) + xfv[None, :] * (
                samp(1, 1, 1, chan) - samp(0, 1, 1, chan))
            l1 = l01 + yfv[:, None] * (l11 - l01)
            out_c.append(l0 + zfv * (l1 - l0))
        return (out_c[0] / out_c[1]).astype(f)

    return App("bilateral_grid", hl.Pipeline(output), [inp], make_inputs,
               reference, [width, height], tolerance=2e-3, atol=2e-3)

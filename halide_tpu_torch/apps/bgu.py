"""bgu: bilateral guided upsampling — per-grid-cell 4x4 symmetric least
squares fit of an affine color model, then trilinear slicing
(reference: apps/bgu/bgu_generator.cpp:150-330, solve_symmetric @88-150).

The reference expresses the per-cell elimination as ~100 scalar update
definitions for scheduling; here the elimination runs symbolically over the
Expr DAG, and the numpy golden runs the SAME generic routine on arrays so
the fp operation order matches exactly.
"""
from __future__ import annotations

import math

import numpy as np

import halide_tpu_torch as hl

from . import App, register


def _solve_symmetric(A, b, M=4, N=3):
    """LDL-style elimination as in the reference's solve_symmetric, written
    generically over any arithmetic scalars (Exprs or numpy arrays).
    A: MxM list-of-lists (symmetric), b: MxN. Returns MxN solution."""
    A = [row[:] for row in A]
    b = [row[:] for row in b]
    for j in range(M):
        A[j][j] = 1.0 / A[j][j]
        for i in range(j + 1, M):
            A[i][j] = A[i][j] * A[j][j]
        for i in range(j + 1, M):
            for k in range(j + 1, M):
                if k < i:
                    A[i][k] = A[k][i]
                else:
                    A[i][k] = A[i][k] - A[k][j] * A[j][i]
    result = [[None] * N for _ in range(M)]
    for k in range(N):
        for j in range(M):
            for i in range(j):
                b[j][k] = b[j][k] - A[j][i] * b[i][k]
        for j in range(M):
            b[j][k] = b[j][k] * A[j][j]
        for j in range(M - 1, -1, -1):
            for i in range(j + 1, M):
                b[j][k] = b[j][k] - A[i][j] * b[i][k]
        for j in range(M):
            result[j][k] = b[j][k]
    return result


_T = [1.0 / 64, 1.0 / 27, 1.0 / 8, 1.0, 1.0 / 8, 1.0 / 27, 1.0 / 64]


@register("bgu")
def build(width: int = 1536, height: int = 2560, s_sigma: int = 8,
          r_sigma: float = 0.125, tile=(512, 256), imz: str = "member",
          imy: str = "inline", slice_form: str = "lerp",
          **_ignored) -> App:
    x, y, z, c = hl.Var("x"), hl.Var("y"), hl.Var("z"), hl.Var("c")
    low_w, low_h = width // s_sigma, height // s_sigma
    splat_loc = hl.ImageParam(hl.Float(32), 3, "splat_loc")   # low-res
    values = hl.ImageParam(hl.Float(32), 3, "values")         # low-res
    slice_loc = hl.ImageParam(hl.Float(32), 3, "slice_loc")   # full-res

    cval = hl.repeat_edge(values, [(0, low_w), (0, low_h), None])
    csplat = hl.repeat_edge(splat_loc, [(0, low_w), (0, low_h), None])
    upsample = max(int(math.ceil(width / low_w)),
                   int(math.ceil(height / low_h)))

    gray_splat = hl.Func("gray_splat_loc")
    gray_splat[x, y] = (0.25 * csplat[x, y, 0] + 0.5 * csplat[x, y, 1]
                        + 0.25 * csplat[x, y, 2])
    gray_slice = hl.Func("gray_slice_loc")
    gray_slice[x, y] = (0.25 * slice_loc[x, y, 0] + 0.5 * slice_loc[x, y, 1]
                        + 0.25 * slice_loc[x, y, 2])

    r = hl.RDom(0, s_sigma, 0, s_sigma, "rbgu")
    hist = hl.Func("bgu_histogram")
    hist[x, y, z, c] = 0.0
    sx = x * s_sigma + r.x - s_sigma // 2
    sy = y * s_sigma + r.y - s_sigma // 2
    pos = hl.clamp(gray_splat[sx, sy], 0.0, 1.0)
    zi = hl.i32(hl.round(pos * (1.0 / r_sigma)))
    vr, vg, vb = (cval[sx, sy, i] for i in range(3))
    sr, sg, sb = (csplat[sx, sy, i] for i in range(3))
    chans = [sr * sr, sr * sg, sr * sb, sr,
             sg * sg, sg * sb, sg,
             sb * sb, sb,
             hl.f32(1.0),
             vr * sr, vr * sg, vr * sb, vr,
             vg * sr, vg * sg, vg * sb, vg,
             vb * sr, vb * sg, vb * sb, vb]
    hist[x, y, zi, c] += hl.mux(c, chans)
    hist.compute_root()

    blurz = hl.Func("bgu_blurz")
    blurz[x, y, z, c] = sum(
        (hist[x, y, z + dz - 3, c] * _T[dz] for dz in range(7)),
        start=hl.f32(0.0))
    blury = hl.Func("bgu_blury")
    blury[x, y, z, c] = sum(
        (blurz[x, y + dy - 3, z, c] * _T[dy] for dy in range(7)),
        start=hl.f32(0.0))
    blurx = hl.Func("bgu_blurx")
    blurx[x, y, z, c] = sum(
        (blury[x + dx - 3, y, z, c] * _T[dx] for dx in range(7)),
        start=hl.f32(0.0))
    blurz.compute_root()
    blurx.compute_root()

    lam = 0.1
    Abase = [[blurx[x, y, z, k] for k in row] for row in
             [[0, 1, 2, 3], [1, 4, 5, 6], [2, 5, 7, 8], [3, 6, 8, 9]]]
    bbase = [[blurx[x, y, z, 10 + j + 4 * k] for k in range(3)]
             for j in range(4)]
    A = [[Abase[i][j] + lam if i == j else Abase[i][j]
          for j in range(4)] for i in range(4)]
    bM = [[bbase[i][j] + lam if i == j else bbase[i][j]
           for j in range(3)] for i in range(4)]
    sol = _solve_symmetric(A, bM)           # 4x3
    line = hl.Func("bgu_line")
    line[x, y, z, c] = hl.mux(
        c, [sol[j][k] for k in range(3) for j in range(4)])
    line.compute_root()

    big_sigma = s_sigma * upsample
    # integer-div cell indices (y >= 0 so floor(f32(y)/B) == y/B exactly,
    # and f32(y)/B is exact for power-of-two B): the affine machinery then
    # keeps the lerp reads on the slice path instead of a per-pixel gather
    yi = y / big_sigma
    yf = hl.f32(y) / big_sigma - hl.f32(yi)
    imy_f = hl.Func("bgu_imy")
    imy_f[x, y, z, c] = hl.lerp(line[x, yi, z, c], line[x, yi + 1, z, c],
                                yf)
    xi = x / big_sigma
    xf = hl.f32(x) / big_sigma - hl.f32(xi)
    imx = hl.Func("bgu_imx")
    imx[x, y, z, c] = hl.lerp(imy_f[xi, y, z, c], imy_f[xi + 1, y, z, c],
                              xf)
    # imx stays inline: materializing it would write a full-res x,y,z,c
    # tensor (~17x the output); inlined, the z-selection in imz collapses
    # the z axis against the coarse `line` grid before anything full-res
    # is stored

    nbins = int(1.0 / r_sigma)
    val2 = hl.clamp(gray_slice[x, y], 0.0, 1.0)
    zv = val2 * nbins
    zi2 = hl.i32(zv)
    zf = zv - zi2
    imz_f = hl.Func("bgu_imz")
    # the slice's two forms (slice_form): "lerp", the z lerp of imx (the
    # JAX app's default), or "corner", z contracted on the raw line
    # corners first, then bilinear in xy
    if slice_form == "corner":
        # corner-first trilinear: contract over z on the RAW line corner
        # values (one weighted sum of static-z planes per corner), THEN
        # bilinear in xy -- vs the lerp form, whose z select-chain
        # re-evaluates a full xy-bilinear tower per unrolled plane.
        # Mathematically identical (linear ops commute); fp rounding
        # differs within the app tolerance.
        nplanes = nbins + 2          # zi2 in [0, nbins], +1 for the shift
        wz = [hl.select(zi2 == zz, 1.0 - zf,
                        hl.select(zi2 == zz - 1, zf, hl.f32(0.0)))
              for zz in range(nplanes)]

        def corner_sum(dx_, dy_):
            return sum((wz[zz] * line[xi + dx_, yi + dy_, zz, c]
                        for zz in range(nplanes)), start=hl.f32(0.0))

        imz_f[x, y, c] = (
            (1.0 - xf) * ((1.0 - yf) * corner_sum(0, 0)
                          + yf * corner_sum(0, 1))
            + xf * ((1.0 - yf) * corner_sum(1, 0)
                    + yf * corner_sum(1, 1)))
    else:
        imz_f[x, y, c] = hl.lerp(imx[x, y, zi2, c],
                                 imx[x, y, zi2 + 1, c], zf)

    interpolated = hl.Func("bgu_interp")
    interpolated[x, y, c] = (
        imz_f[x, y, 4 * c + 0] * slice_loc[x, y, 0]
        + imz_f[x, y, 4 * c + 1] * slice_loc[x, y, 1]
        + imz_f[x, y, 4 * c + 2] * slice_loc[x, y, 2]
        + imz_f[x, y, 4 * c + 3])

    output = hl.Func("bgu_out")
    output[x, y, c] = hl.clamp(interpolated[x, y, c], 0.0, 1.0)

    # slice schedule (reference: apps/bgu/bgu_generator.cpp:495-575 tiles
    # the full-res slice): one stencil-group kernel per tile (512x256 by
    # default, clamped to the extent with a floor of 8), the coarse `line`
    # table staged as a window with div-indexed x and y dims. imz is a
    # member by default: inline, interpolated's 4 c + j reads would repeat
    # its whole z-select tower four times. imy="member" makes the y-lerp
    # at coarse x a member too; tile=None computes everything whole-array.
    if tile is not None:
        tx, ty = tile
        xo, yo = hl.Var("xo"), hl.Var("yo")
        xin, yin = hl.Var("xin"), hl.Var("yin")
        output.tile(x, y, xo, yo, xin, yin, max(min(tx, width), 8),
                    max(min(ty, height), 8)) \
              .vectorize(xin).parallel(yo)
        interpolated.compute_at(output, xo)
        if imz == "member":
            imz_f.compute_at(output, xo)
        if imy == "member":
            imy_f.compute_at(output, xo)

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        full = rng.random((3, height, width), np.float32)
        low = full[:, ::s_sigma, ::s_sigma][:, :low_h, :low_w].copy()
        vals = np.clip(low * 0.8 + 0.1, 0, 1).astype(np.float32)
        return {"splat_loc": low, "values": vals, "slice_loc": full}

    def reference(splat_loc, values, slice_loc):
        f = np.float32
        Z = nbins + 1 + 6   # z box: [-3, nbins+3]
        z0 = -3
        # the histogram grid is indexed by the slicing: xi in
        # [0, (W-1)//big_sigma + 1], plus the 7-tap blur margins
        gx0, gx1 = -3, (width - 1) // big_sigma + 1 + 3
        gy0, gy1 = -3, (height - 1) // big_sigma + 1 + 3
        gw, gh = gx1 - gx0 + 1, gy1 - gy0 + 1
        histn = np.zeros((22, Z + 6, gh, gw), f)   # extra z margin for blur
        zoff = -z0 + 3

        def rd(img, xs, ys):
            return img[..., np.clip(ys, 0, low_h - 1)[:, None],
                       np.clip(xs, 0, low_w - 1)[None, :]]

        gxs = np.arange(gx0, gx1 + 1)
        gys = np.arange(gy0, gy1 + 1)
        gsl = (0.25 * splat_loc[0] + 0.5 * splat_loc[1]
               + 0.25 * splat_loc[2]).astype(f)
        for ry in range(s_sigma):
            pys = gys * s_sigma + ry - s_sigma // 2
            for rx in range(s_sigma):
                pxs = gxs * s_sigma + rx - s_sigma // 2
                pos = np.clip(rd(gsl[None], pxs, pys)[0], 0, 1)
                ziv = np.round(pos * f(1.0 / r_sigma)).astype(np.int32)
                sr_, sg_, sb_ = (rd(splat_loc, pxs, pys)[i]
                                 for i in range(3))
                vr_, vg_, vb_ = (rd(values, pxs, pys)[i] for i in range(3))
                ch = np.stack([sr_ * sr_, sr_ * sg_, sr_ * sb_, sr_,
                               sg_ * sg_, sg_ * sb_, sg_,
                               sb_ * sb_, sb_,
                               np.ones_like(sr_),
                               vr_ * sr_, vr_ * sg_, vr_ * sb_, vr_,
                               vg_ * sr_, vg_ * sg_, vg_ * sb_, vg_,
                               vb_ * sr_, vb_ * sg_, vb_ * sb_, vb_])
                iy, ix = np.meshgrid(np.arange(gh), np.arange(gw),
                                     indexing="ij")
                np.add.at(histn, (slice(None), ziv + zoff, iy, ix), ch)

        def blur7(a, axis):
            out = np.zeros_like(a)
            n = a.shape[axis]
            pad = [(0, 0)] * a.ndim
            pad[axis] = (3, 3)
            ap = np.pad(a, pad, mode="constant")
            for i, t in enumerate(_T):
                sl = [slice(None)] * a.ndim
                sl[axis] = slice(i, i + n)
                out += f(t) * ap[tuple(sl)]
            return out

        # blur order z, y, x (axes: 1=z, 2=y, 3=x)
        g = blur7(blur7(blur7(histn, 1), 2), 3)

        # per-cell solve over the whole grid with the SAME generic routine
        Ag = [[None] * 4 for _ in range(4)]
        idxA = [[0, 1, 2, 3], [1, 4, 5, 6], [2, 5, 7, 8], [3, 6, 8, 9]]
        for i in range(4):
            for j in range(4):
                Ag[i][j] = g[idxA[i][j]] + (f(lam) if i == j else f(0.0))
        bg = [[g[10 + j + 4 * k] + (f(lam) if j == k else f(0.0))
               for k in range(3)] for j in range(4)]
        sol_np = _solve_symmetric(Ag, bg)    # 4x3 of arrays [Z+6, gh, gw]
        linev = np.stack([sol_np[j][k] for k in range(3) for j in range(4)])

        # slicing
        ys_full = np.arange(height)
        xs_full = np.arange(width)
        yfv = ys_full / f(big_sigma)
        yiv = np.floor(yfv).astype(np.int32)
        yfv = (yfv - yiv).astype(f)
        xfv = xs_full / f(big_sigma)
        xiv = np.floor(xfv).astype(np.int32)
        xfv = (xfv - xiv).astype(f)

        def line_at(xq, yq, zq):
            return linev[:, zq + zoff, yq - gy0, :][..., xq - gx0]

        gsl2 = (0.25 * slice_loc[0] + 0.5 * slice_loc[1]
                + 0.25 * slice_loc[2]).astype(f)
        val = np.clip(gsl2, 0, 1)
        zvv = val * nbins
        zi2v = zvv.astype(np.int32)
        zfv = (zvv - zi2v).astype(f)

        # imy: lerp over y at low-res x
        # evaluate on the fly for the full-res grid:
        yq0 = yiv[:, None]
        yq1 = yiv[:, None] + 1
        xq0 = xiv[None, :]
        xq1 = xiv[None, :] + 1
        out = np.zeros((3, height, width), f)
        comp = np.zeros((12, height, width), f)
        for ch in range(12):
            l_ = linev[ch]

            def L(xq, yq, zq):
                return l_[zq + zoff, yq - gy0, xq - gx0]

            # interpolated_matrix_y then _x at the two z levels
            def imy_at(xq, zq):
                a = L(xq, yq0, zq)
                b2 = L(xq, yq1, zq)
                return a + yfv[:, None] * (b2 - a)

            def imx_at(zq):
                a = imy_at(xq0, zq)
                b2 = imy_at(xq1, zq)
                return a + xfv[None, :] * (b2 - a)

            v0 = imx_at(zi2v)
            v1 = imx_at(zi2v + 1)
            comp[ch] = v0 + zfv * (v1 - v0)
        for ci in range(3):
            out[ci] = (comp[4 * ci + 0] * slice_loc[0]
                       + comp[4 * ci + 1] * slice_loc[1]
                       + comp[4 * ci + 2] * slice_loc[2]
                       + comp[4 * ci + 3])
        return np.clip(out, 0, 1).astype(f)

    return App("bgu", hl.Pipeline(output),
               [splat_loc, values, slice_loc], make_inputs, reference,
               [width, height, 3], megapixels=width * height / 1e6,
               tolerance=5e-3, atol=5e-3, mismatch_frac=0.002)

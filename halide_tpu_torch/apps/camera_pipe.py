"""camera_pipe: full ISP -- hot-pixel suppression, deinterleave, demosaic,
color-correct, tone curve, sharpen, bit-exact u8
(reference: apps/camera_pipe/camera_pipe_generator.cpp:236-422, Demosaic
@28-145).

Two schedules, chosen by `build()`'s arguments (the JAX app's env gates
HALIDE_TPU_CP_KERNEL, HALIDE_TPU_CP_TILE and HALIDE_TPU_CP_ROOTS):
- `kernel=True`: the full-resolution back half (demosaic interleave, color
  matrix, tone curve, sharpen) tiled by `tile` (256x64 by default, as the
  JAX app's), computed in one stencil-group kernel launch that stages the
  half-resolution planes (deinterleaved, g_r, g_b) as div-indexed (d = 2)
  windows; a full-width tile (2560x128 at the canonical size) makes it a
  band walk. Where the tile does not divide the output, the other branch;
- the default: whole-array, with the stages named in `roots` computed at
  root (the JAX app's default set; an unknown name raises).

The tone curve is computed inline per pixel, as in the JAX app.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

import halide_tpu_torch as hl

from . import App, register

DEFAULT_ROOTS = "deinterleaved,g_r,g_b,demosaiced,curved"


def _avg(a, b):
    from halide_tpu_torch.expr import to_expr
    a = to_expr(a)
    t = a.dtype
    wider = hl.Type(t.code, t.bits * 2)
    return hl.cast(t, (hl.cast(wider, a) + b + 1) / 2)


def _blur121(a, b, c):
    return _avg(_avg(a, c), b)


def _curve_constants(black_level, white_level, contrast):
    inv_range = 1.0 / (white_level - black_level)
    b_c = 2.0 - 2.0 ** (contrast / 100.0)
    return inv_range, 2.0 - 2.0 * b_c, b_c


def tone_curve(x, black_level=25, white_level=1023, gamma=2.0,
               contrast=50.0):
    """The tone curve over raw values x in [0, 1024), a u8 Func scheduled
    inline (the JAX app recomputes it per pixel in place of a LUT)."""
    inv_range, a_c, b_c = _curve_constants(black_level, white_level,
                                           contrast)
    curve = hl.Func("curve")
    xf = hl.clamp(hl.f32(x - black_level) * inv_range, 0.0, 1.0)
    g2 = hl.pow(xf, 1.0 / gamma)
    z = hl.select(g2 > 0.5,
                  1.0 - (a_c * (1.0 - g2) * (1.0 - g2) + b_c * (1.0 - g2)),
                  a_c * g2 * g2 + b_c * g2)
    val = hl.u8(hl.clamp(z * 255.0 + 0.5, 0.0, 255.0))
    curve[x] = hl.select(x <= black_level, hl.u8(0),
                         hl.select(x > white_level, hl.u8(255), val))
    curve.compute_inline()
    return curve


def curve_lut(black_level=25, white_level=1023, gamma=2.0, contrast=50.0):
    """The golden's tone curve: the 1,024-entry numpy LUT."""
    inv_range, a_c, b_c = _curve_constants(black_level, white_level,
                                           contrast)
    lut_x = np.arange(1024)
    xf_l = np.clip((lut_x - black_level).astype(np.float32)
                   * np.float32(inv_range), 0.0, 1.0)
    g_l = np.power(xf_l, np.float32(1.0 / gamma))
    z_l = np.where(
        g_l > 0.5,
        1.0 - (np.float32(a_c) * (1 - g_l) * (1 - g_l)
               + np.float32(b_c) * (1 - g_l)),
        np.float32(a_c) * g_l * g_l + np.float32(b_c) * g_l)
    val_l = np.clip(z_l * np.float32(255.0) + np.float32(0.5),
                    0, 255).astype(np.uint8)
    return np.where(lut_x <= black_level, np.uint8(0),
                    np.where(lut_x > white_level, np.uint8(255), val_l))


@register("camera_pipe")
def build(out_width: int = 2560, out_height: int = 1920,
          color_temp: float = 3700.0, gamma: float = 2.0,
          contrast: float = 50.0, sharpen_strength: float = 1.0,
          black_level: int = 25, white_level: int = 1023,
          kernel: bool = False, tile: Tuple[int, int] = (256, 64),
          roots: str = DEFAULT_ROOTS) -> App:
    x, y, c = hl.Var("x"), hl.Var("y"), hl.Var("c")
    W, H = out_width, out_height
    in_w, in_h = W + 32, H + 48
    raw = hl.ImageParam(hl.UInt(16), 2, "input")
    matrix_3200 = hl.ImageParam(hl.Float(32), 2, "matrix_3200")
    matrix_7000 = hl.ImageParam(hl.Float(32), 2, "matrix_7000")

    shifted = hl.Func("shifted")
    shifted[x, y] = raw[x + 16, y + 12]

    # hot pixel suppression
    denoised = hl.Func("denoised")
    a = hl.max(shifted[x - 2, y], shifted[x + 2, y],
               shifted[x, y - 2], shifted[x, y + 2])
    denoised[x, y] = hl.clamp(shifted[x, y], hl.u16(0), a)

    deinterleaved = hl.Func("deinterleaved")
    deinterleaved[x, y, c] = hl.mux(c, [
        denoised[2 * x, 2 * y], denoised[2 * x + 1, 2 * y],
        denoised[2 * x, 2 * y + 1], denoised[2 * x + 1, 2 * y + 1]])

    # ---- demosaic ------------------------------------------------------
    g_gr = hl.Func("g_gr")
    g_gr[x, y] = deinterleaved[x, y, 0]
    r_r = hl.Func("r_r")
    r_r[x, y] = deinterleaved[x, y, 1]
    b_b = hl.Func("b_b")
    b_b[x, y] = deinterleaved[x, y, 2]
    g_gb = hl.Func("g_gb")
    g_gb[x, y] = deinterleaved[x, y, 3]

    gv_r = _avg(g_gb[x, y - 1], g_gb[x, y])
    gvd_r = hl.absd(g_gb[x, y - 1], g_gb[x, y])
    gh_r = _avg(g_gr[x + 1, y], g_gr[x, y])
    ghd_r = hl.absd(g_gr[x + 1, y], g_gr[x, y])
    g_r = hl.Func("g_r")
    g_r[x, y] = hl.select(ghd_r < gvd_r, gh_r, gv_r)

    gv_b = _avg(g_gr[x, y + 1], g_gr[x, y])
    gvd_b = hl.absd(g_gr[x, y + 1], g_gr[x, y])
    gh_b = _avg(g_gb[x - 1, y], g_gb[x, y])
    ghd_b = hl.absd(g_gb[x - 1, y], g_gb[x, y])
    g_b = hl.Func("g_b")
    g_b[x, y] = hl.select(ghd_b < gvd_b, gh_b, gv_b)

    r_gr = hl.Func("r_gr")
    r_gr[x, y] = (g_gr[x, y] - _avg(g_r[x, y], g_r[x - 1, y])) \
        + _avg(r_r[x - 1, y], r_r[x, y])
    b_gr = hl.Func("b_gr")
    b_gr[x, y] = (g_gr[x, y] - _avg(g_b[x, y], g_b[x, y - 1])) \
        + _avg(b_b[x, y], b_b[x, y - 1])
    r_gb = hl.Func("r_gb")
    r_gb[x, y] = (g_gb[x, y] - _avg(g_r[x, y], g_r[x, y + 1])) \
        + _avg(r_r[x, y], r_r[x, y + 1])
    b_gb = hl.Func("b_gb")
    b_gb[x, y] = (g_gb[x, y] - _avg(g_b[x, y], g_b[x + 1, y])) \
        + _avg(b_b[x, y], b_b[x + 1, y])

    rp_b = (g_b[x, y] - _avg(g_r[x, y], g_r[x - 1, y + 1])) \
        + _avg(r_r[x, y], r_r[x - 1, y + 1])
    rpd_b = hl.absd(r_r[x, y], r_r[x - 1, y + 1])
    rn_b = (g_b[x, y] - _avg(g_r[x - 1, y], g_r[x, y + 1])) \
        + _avg(r_r[x - 1, y], r_r[x, y + 1])
    rnd_b = hl.absd(r_r[x - 1, y], r_r[x, y + 1])
    r_b = hl.Func("r_b")
    r_b[x, y] = hl.select(rpd_b < rnd_b, rp_b, rn_b)

    bp_r = (g_r[x, y] - _avg(g_b[x, y], g_b[x + 1, y - 1])) \
        + _avg(b_b[x, y], b_b[x + 1, y - 1])
    bpd_r = hl.absd(b_b[x, y], b_b[x + 1, y - 1])
    bn_r = (g_r[x, y] - _avg(g_b[x + 1, y], g_b[x, y - 1])) \
        + _avg(b_b[x + 1, y], b_b[x, y - 1])
    bnd_r = hl.absd(b_b[x + 1, y], b_b[x, y - 1])
    b_r = hl.Func("b_r")
    b_r[x, y] = hl.select(bpd_r < bnd_r, bp_r, bn_r)

    def interleave_x(a_f, b_f):
        out = hl.Func(a_f.name + "_ix")
        out[x, y] = hl.select((x % 2) == 0, a_f[x / 2, y], b_f[x / 2, y])
        return out

    def interleave_y(a_f, b_f):
        out = hl.Func(a_f.name + "_iy")
        out[x, y] = hl.select((y % 2) == 0, a_f[x, y / 2], b_f[x, y / 2])
        return out

    r_full = interleave_y(interleave_x(r_gr, r_r), interleave_x(r_b, r_gb))
    g_full = interleave_y(interleave_x(g_gr, g_r), interleave_x(g_b, g_gb))
    b_full = interleave_y(interleave_x(b_gr, b_r), interleave_x(b_b, b_gb))

    demosaiced = hl.Func("demosaiced")
    demosaiced[x, y, c] = hl.i16(hl.mux(c, [r_full[x, y], g_full[x, y],
                                            b_full[x, y]]))

    # ---- color correction ----------------------------------------------
    kelvin = color_temp
    alpha = (1.0 / kelvin - 1.0 / 3200) / (1.0 / 7000 - 1.0 / 3200)
    matrix = hl.Func("matrix")
    matrix[x, y] = hl.i16(
        (matrix_3200[x, y] * alpha + matrix_7000[x, y] * (1 - alpha))
        * 256.0)
    matrix.compute_root()

    ir = hl.i32(demosaiced[x, y, 0])
    ig = hl.i32(demosaiced[x, y, 1])
    ib = hl.i32(demosaiced[x, y, 2])
    rr = matrix[3, 0] + matrix[0, 0] * ir + matrix[1, 0] * ig \
        + matrix[2, 0] * ib
    gg = matrix[3, 1] + matrix[0, 1] * ir + matrix[1, 1] * ig \
        + matrix[2, 1] * ib
    bb = matrix[3, 2] + matrix[0, 2] * ir + matrix[1, 2] * ig \
        + matrix[2, 2] * ib
    corrected = hl.Func("corrected")
    corrected[x, y, c] = hl.mux(c, [hl.i16(rr / 256), hl.i16(gg / 256),
                                    hl.i16(bb / 256)])

    # ---- tone curve, computed inline per pixel ---------------------------
    curve = tone_curve(x, black_level, white_level, gamma, contrast)

    curved = hl.Func("curved")
    curved[x, y, c] = curve[hl.clamp(hl.i32(corrected[x, y, c]), 0, 1023)]

    # ---- sharpen --------------------------------------------------------
    strength_x32 = int(np.clip(round(sharpen_strength * 32), 0, 255))
    unsharp_y = hl.Func("unsharp_y")
    unsharp_y[x, y, c] = _blur121(curved[x, y - 1, c], curved[x, y, c],
                                  curved[x, y + 1, c])
    unsharp = hl.Func("unsharp")
    unsharp[x, y, c] = _blur121(unsharp_y[x - 1, y, c], unsharp_y[x, y, c],
                                unsharp_y[x + 1, y, c])
    mask = hl.Func("mask")
    mask[x, y, c] = hl.i16(curved[x, y, c]) - hl.i16(unsharp[x, y, c])
    processed = hl.Func("processed")
    processed[x, y, c] = hl.saturating_cast(
        hl.UInt(8), curved[x, y, c] + (mask[x, y, c] * strength_x32) / 32)

    if kernel and W % tile[0] == 0 and H % tile[1] == 0:
        xo, yo, xin, yin = (hl.Var("xo"), hl.Var("yo"),
                            hl.Var("xin"), hl.Var("yin"))
        processed.tile(x, y, xo, yo, xin, yin, tile[0], tile[1]) \
                 .vectorize(xin).parallel(yo)
        deinterleaved.compute_root()
        g_r.compute_root()
        g_b.compute_root()
        demosaiced.compute_at(processed, xo)
        curved.compute_at(processed, xo)
        unsharp_y.compute_at(processed, xo)
    else:
        # deinterleaved must materialize: inline, every raw read inside
        # the demosaic becomes the non-affine 2 * (x / 2) + k, a gather
        by_name = {"denoised": denoised, "deinterleaved": deinterleaved,
                   "g_r": g_r, "g_b": g_b, "demosaiced": demosaiced,
                   "curved": curved, "unsharp_y": unsharp_y}
        for n in filter(None, roots.split(",")):
            if n not in by_name:
                raise hl.CompileError(
                    f"camera_pipe roots: unknown stage {n!r}; valid: "
                    + ", ".join(sorted(by_name)))
            by_name[n].compute_root()

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        m32 = np.array([[1.6697, -0.2693, -0.4004, -42.4346],
                        [-0.3576, 1.0615, 1.5949, -37.1158],
                        [-0.2175, -1.8751, 6.9640, -26.6970]],
                       np.float32)
        m70 = np.array([[2.2997, -0.4478, 0.1706, -39.0923],
                        [-0.3826, 1.5906, -0.2080, -25.4311],
                        [-0.0888, -0.7344, 2.2832, -20.0826]],
                       np.float32)
        return {
            "input": rng.integers(0, 1024, (in_h, in_w), np.uint16),
            "matrix_3200": m32,
            "matrix_7000": m70,
        }

    def reference(input, matrix_3200, matrix_7000):
        u16, u32, i16, i32 = np.uint16, np.uint32, np.int16, np.int32
        fdiv = np.floor_divide
        raw_a = input

        def avg_np(p, q):
            return ((p.astype(u32) + q + 1) // 2).astype(p.dtype)

        def absd_np(p, q):
            return np.where(p > q, p - q, q - p)

        # denoised over fullres coords [-6, W+6) x [-6, H+6), origin OD=-6
        OD = 6
        S = raw_a[12 - OD - 2:12 + H + OD + 2,
                  16 - OD - 2:16 + W + OD + 2].astype(u16)
        core = S[2:-2, 2:-2]
        mx = np.maximum.reduce([S[2:-2, :-4], S[2:-2, 4:],
                                S[:-4, 2:-2], S[4:, 2:-2]])
        D = np.minimum(np.maximum(core, u16(0)), mx)   # origin -OD

        def den(xq, yq):
            return D[yq + OD, xq + OD]

        def g_gr_n(xq, yq):
            return den(2 * xq, 2 * yq)

        def r_r_n(xq, yq):
            return den(2 * xq + 1, 2 * yq)

        def b_b_n(xq, yq):
            return den(2 * xq, 2 * yq + 1)

        def g_gb_n(xq, yq):
            return den(2 * xq + 1, 2 * yq + 1)

        def g_r_n(xq, yq):
            gv = avg_np(g_gb_n(xq, yq - 1), g_gb_n(xq, yq))
            gvd = absd_np(g_gb_n(xq, yq - 1), g_gb_n(xq, yq))
            gh = avg_np(g_gr_n(xq + 1, yq), g_gr_n(xq, yq))
            ghd = absd_np(g_gr_n(xq + 1, yq), g_gr_n(xq, yq))
            return np.where(ghd < gvd, gh, gv)

        def g_b_n(xq, yq):
            gv = avg_np(g_gr_n(xq, yq + 1), g_gr_n(xq, yq))
            gvd = absd_np(g_gr_n(xq, yq + 1), g_gr_n(xq, yq))
            gh = avg_np(g_gb_n(xq - 1, yq), g_gb_n(xq, yq))
            ghd = absd_np(g_gb_n(xq - 1, yq), g_gb_n(xq, yq))
            return np.where(ghd < gvd, gh, gv)

        def r_gr_n(xq, yq):
            return (g_gr_n(xq, yq) - avg_np(g_r_n(xq, yq), g_r_n(xq - 1, yq))
                    + avg_np(r_r_n(xq - 1, yq), r_r_n(xq, yq)))

        def b_gr_n(xq, yq):
            return (g_gr_n(xq, yq) - avg_np(g_b_n(xq, yq), g_b_n(xq, yq - 1))
                    + avg_np(b_b_n(xq, yq), b_b_n(xq, yq - 1)))

        def r_gb_n(xq, yq):
            return (g_gb_n(xq, yq) - avg_np(g_r_n(xq, yq), g_r_n(xq, yq + 1))
                    + avg_np(r_r_n(xq, yq), r_r_n(xq, yq + 1)))

        def b_gb_n(xq, yq):
            return (g_gb_n(xq, yq) - avg_np(g_b_n(xq, yq), g_b_n(xq + 1, yq))
                    + avg_np(b_b_n(xq, yq), b_b_n(xq + 1, yq)))

        def r_b_n(xq, yq):
            rp = (g_b_n(xq, yq)
                  - avg_np(g_r_n(xq, yq), g_r_n(xq - 1, yq + 1))
                  + avg_np(r_r_n(xq, yq), r_r_n(xq - 1, yq + 1)))
            rpd = absd_np(r_r_n(xq, yq), r_r_n(xq - 1, yq + 1))
            rn = (g_b_n(xq, yq)
                  - avg_np(g_r_n(xq - 1, yq), g_r_n(xq, yq + 1))
                  + avg_np(r_r_n(xq - 1, yq), r_r_n(xq, yq + 1)))
            rnd = absd_np(r_r_n(xq - 1, yq), r_r_n(xq, yq + 1))
            return np.where(rpd < rnd, rp, rn)

        def b_r_n(xq, yq):
            bp = (g_r_n(xq, yq)
                  - avg_np(g_b_n(xq, yq), g_b_n(xq + 1, yq - 1))
                  + avg_np(b_b_n(xq, yq), b_b_n(xq + 1, yq - 1)))
            bpd = absd_np(b_b_n(xq, yq), b_b_n(xq + 1, yq - 1))
            bn = (g_r_n(xq, yq)
                  - avg_np(g_b_n(xq + 1, yq), g_b_n(xq, yq - 1))
                  + avg_np(b_b_n(xq + 1, yq), b_b_n(xq, yq - 1)))
            bnd = absd_np(b_b_n(xq + 1, yq), b_b_n(xq, yq - 1))
            return np.where(bpd < bnd, bp, bn)

        def interleave(ee, oe, eo, oo, xq, yq):
            hx, hy = fdiv(xq, 2), fdiv(yq, 2)
            xe, ye = xq % 2 == 0, yq % 2 == 0
            return np.where(ye,
                            np.where(xe, ee(hx, hy), oe(hx, hy)),
                            np.where(xe, eo(hx, hy), oo(hx, hy)))

        # full-res region [-2, W+2) x [-2, H+2), origin OF=-2
        OF = 2
        yq, xq = np.meshgrid(np.arange(-OF, H + OF),
                             np.arange(-OF, W + OF), indexing="ij")
        rF = interleave(r_gr_n, r_r_n, r_b_n, r_gb_n, xq, yq).astype(i16)
        gF = interleave(g_gr_n, g_r_n, g_b_n, g_gb_n, xq, yq).astype(i16)
        bF = interleave(b_gr_n, b_r_n, b_b_n, b_gb_n, xq, yq).astype(i16)

        alpha_f = np.float32(alpha)
        mat = ((matrix_3200 * alpha_f + matrix_7000 * (1 - alpha_f))
               * np.float32(256.0)).astype(i16)   # np[y, x] 3x4

        def correct(chan_idx):
            m = mat[chan_idx]
            acc = (m[3].astype(i32)
                   + m[0] * rF.astype(i32) + m[1] * gF.astype(i32)
                   + m[2] * bF.astype(i32))
            return fdiv(acc, 256).astype(i16)

        corr = np.stack([correct(0), correct(1), correct(2)])  # [c, y, x]

        lut = curve_lut(black_level, white_level, gamma, contrast)

        curved_r = lut[np.clip(corr.astype(i32), 0, 1023)]

        uy = avg_np(avg_np(curved_r[:, :-2, 1:-1], curved_r[:, 2:, 1:-1]),
                    curved_r[:, 1:-1, 1:-1])
        un = avg_np(avg_np(uy[:, :, :-2], uy[:, :, 2:]), uy[:, :, 1:-1])
        cc = curved_r[:, 2:-2, 2:-2]
        msk = cc.astype(i16) - un[:, 1:-1, :].astype(i16)
        sharp = cc.astype(i32) + fdiv(msk.astype(i32) * strength_x32, 32)
        return np.clip(sharp, 0, 255).astype(np.uint8)

    return App("camera_pipe", hl.Pipeline(processed),
               [raw, matrix_3200, matrix_7000], make_inputs, reference,
               [W, H, 3], megapixels=W * H / 1e6, tolerance=0.0, atol=0.0)

"""Plain PyTorch reference of camera_pipe (Halide's
apps/camera_pipe/camera_pipe_generator.cpp: hot-pixel suppression,
deinterleave, demosaic, colour correction, tone curve, sharpen), the same
arithmetic as the app's numpy golden, frozen here, on whole planes in
int32 where the golden works in uint16 and uint32: every value the golden
keeps in uint16 lies in [0, 1024) here, and its wrapped differences are
read back as int16, which int32 arithmetic gives exactly.

The floating-point steps are the colour matrices' blend and the tone
curve's 1,024-entry table, both computed as the golden does in numpy
float32 (the table on the host: it is 1,024 values). `dtype` is their
type; the configuration states float32 (the lower-precision control passes
bfloat16, and computes both in it).

Imports nothing of the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

from bench_h100.u16 import to_i32


def _avg(p, q):
    return torch.div(p + q + 1, 2, rounding_mode="floor")


def _absd(p, q):
    return (p - q).abs()


def _sel(cond, a, b):
    return torch.where(cond, a, b)


def _i16(v):
    """int32 values read back as int16 (the golden's astype(int16))."""
    return v.to(torch.int16).to(torch.int32)


def curve_lut(black_level, white_level, gamma, contrast, dtype):
    """The tone curve's table over raw values [0, 1024), as the golden's
    `curve_lut`, in `dtype` (numpy float32, or torch's bfloat16)."""
    inv_range = 1.0 / (white_level - black_level)
    b_c = 2.0 - 2.0 ** (contrast / 100.0)
    a_c = 2.0 - 2.0 * b_c
    lut_x = np.arange(1024)
    if dtype == torch.float32:
        f = np.float32
        xf = np.clip((lut_x - black_level).astype(f) * f(inv_range), 0.0, 1.0)
        g = np.power(xf, f(1.0 / gamma))
        z = np.where(g > 0.5, 1.0 - (f(a_c) * (1 - g) * (1 - g)
                                     + f(b_c) * (1 - g)),
                     f(a_c) * g * g + f(b_c) * g)
        val = np.clip(z * f(255.0) + f(0.5), 0, 255).astype(np.uint8)
        val = torch.from_numpy(val.astype(np.int32))
    else:
        def c(v):
            return torch.tensor(v, dtype=dtype)
        xf = ((torch.from_numpy(lut_x - black_level).to(dtype)
               * c(inv_range)).clamp(0.0, 1.0))
        g = torch.pow(xf, c(1.0 / gamma))
        one = c(1.0)
        z = torch.where(g > 0.5, one - (c(a_c) * (one - g) * (one - g)
                                        + c(b_c) * (one - g)),
                        c(a_c) * g * g + c(b_c) * g)
        val = (z * c(255.0) + c(0.5)).clamp(0, 255).to(torch.int32)
    lut_x = torch.from_numpy(lut_x)
    return torch.where(lut_x <= black_level, 0,
                       torch.where(lut_x > white_level, 255, val))


def reference(inputs: dict, args: dict, dtype=torch.float32) -> torch.Tensor:
    """inputs: "input" uint16 [H + 48, W + 32], "matrix_3200" and
    "matrix_7000" float32 [3, 4]; -> uint8 [3, H, W]."""
    raw = to_i32(inputs["input"])
    dev = raw.device
    H, W = raw.shape[0] - 48, raw.shape[1] - 32

    # denoised over full-resolution [-6, W + 6) x [-6, H + 6)
    OD = 6
    S = raw[12 - OD - 2:12 + H + OD + 2, 16 - OD - 2:16 + W + OD + 2]
    core = S[2:-2, 2:-2]
    mx = torch.maximum(torch.maximum(S[2:-2, :-4], S[2:-2, 4:]),
                       torch.maximum(S[:-4, 2:-2], S[4:, 2:-2]))
    D = torch.minimum(core, mx)          # core >= 0 already
    del S, mx

    # the four half-resolution planes over [-3, W/2 + 3) x [-3, H/2 + 3):
    # plane[y, x] at half-resolution (x, y), origin (-3, -3)
    g_gr = D[0::2, 0::2]
    r_r = D[0::2, 1::2]
    b_b = D[1::2, 0::2]
    g_gb = D[1::2, 1::2]
    O = 3

    def at(p, dx, dy, ny, nx):
        """p over half-resolution [dx, dx + nx) x [dy, dy + ny) from the
        plane's origin -3, i.e. p(x + dx, y + dy) for x, y from -2."""
        return p[O - 2 + dy:O - 2 + dy + ny, O - 2 + dx:O - 2 + dx + nx]

    def g_r_at(ny, nx):
        a, b = at(g_gb, 0, -1, ny, nx), at(g_gb, 0, 0, ny, nx)
        c, d = at(g_gr, 1, 0, ny, nx), at(g_gr, 0, 0, ny, nx)
        return _sel(_absd(c, d) < _absd(a, b), _avg(c, d), _avg(a, b))

    def g_b_at(ny, nx):
        a, b = at(g_gr, 0, 1, ny, nx), at(g_gr, 0, 0, ny, nx)
        c, d = at(g_gb, -1, 0, ny, nx), at(g_gb, 0, 0, ny, nx)
        return _sel(_absd(c, d) < _absd(a, b), _avg(c, d), _avg(a, b))

    # g_r and g_b over half-resolution [-2, W/2 + 2) x [-2, H/2 + 2):
    # index (y + 2, x + 2) holds (x, y)
    gr = g_r_at(H // 2 + 4, W // 2 + 4)
    gb = g_b_at(H // 2 + 4, W // 2 + 4)

    # the full-resolution box [-2, W + 2) x [-2, H + 2) that the sharpen
    # reads is half-resolution [-1, W/2 + 1) x [-1, H/2 + 1)
    n_y, n_x = H // 2 + 2, W // 2 + 2

    def P(p, dx, dy):               # a raw plane at (x + dx, y + dy)
        return at(p, 1 + dx, 1 + dy, n_y, n_x)

    def G(p, dx, dy):               # g_r or g_b at (x + dx, y + dy)
        return p[1 + dy:1 + dy + n_y, 1 + dx:1 + dx + n_x]

    r_gr = P(g_gr, 0, 0) - _avg(G(gr, 0, 0), G(gr, -1, 0)) \
        + _avg(P(r_r, -1, 0), P(r_r, 0, 0))
    b_gr = P(g_gr, 0, 0) - _avg(G(gb, 0, 0), G(gb, 0, -1)) \
        + _avg(P(b_b, 0, 0), P(b_b, 0, -1))
    r_gb = P(g_gb, 0, 0) - _avg(G(gr, 0, 0), G(gr, 0, 1)) \
        + _avg(P(r_r, 0, 0), P(r_r, 0, 1))
    b_gb = P(g_gb, 0, 0) - _avg(G(gb, 0, 0), G(gb, 1, 0)) \
        + _avg(P(b_b, 0, 0), P(b_b, 1, 0))

    rp = G(gb, 0, 0) - _avg(G(gr, 0, 0), G(gr, -1, 1)) \
        + _avg(P(r_r, 0, 0), P(r_r, -1, 1))
    rpd = _absd(P(r_r, 0, 0), P(r_r, -1, 1))
    rn = G(gb, 0, 0) - _avg(G(gr, -1, 0), G(gr, 0, 1)) \
        + _avg(P(r_r, -1, 0), P(r_r, 0, 1))
    rnd = _absd(P(r_r, -1, 0), P(r_r, 0, 1))
    r_b = _sel(rpd < rnd, rp, rn)

    bp = G(gr, 0, 0) - _avg(G(gb, 0, 0), G(gb, 1, -1)) \
        + _avg(P(b_b, 0, 0), P(b_b, 1, -1))
    bpd = _absd(P(b_b, 0, 0), P(b_b, 1, -1))
    bn = G(gr, 0, 0) - _avg(G(gb, 1, 0), G(gb, 0, -1)) \
        + _avg(P(b_b, 1, 0), P(b_b, 0, -1))
    bnd = _absd(P(b_b, 1, 0), P(b_b, 0, -1))
    b_r = _sel(bpd < bnd, bp, bn)

    def interleave(ee, oe, eo, oo):
        """Full resolution over [-2, W + 2) x [-2, H + 2) from the four
        half-resolution values over [-1, W/2 + 1) (x even/odd, y
        even/odd)."""
        out = torch.empty((2 * n_y, 2 * n_x), dtype=torch.int32, device=dev)
        out[0::2, 0::2] = ee
        out[0::2, 1::2] = oe
        out[1::2, 0::2] = eo
        out[1::2, 1::2] = oo
        return _i16(out)

    rF = interleave(r_gr, P(r_r, 0, 0), r_b, r_gb)
    gF = interleave(P(g_gr, 0, 0), G(gr, 0, 0), G(gb, 0, 0), P(g_gb, 0, 0))
    bF = interleave(b_gr, b_r, P(b_b, 0, 0), b_gb)
    del gr, gb, D

    # colour correction: the matrices blended at the colour temperature
    kelvin = float(args["color_temp"])
    alpha = (1.0 / kelvin - 1.0 / 3200) / (1.0 / 7000 - 1.0 / 3200)
    m32 = inputs["matrix_3200"].to("cpu")
    m70 = inputs["matrix_7000"].to("cpu")
    if dtype == torch.float32:
        af = np.float32(alpha)
        mat = ((m32.numpy() * af + m70.numpy() * (1 - af))
               * np.float32(256.0)).astype(np.int16)
        mat = torch.from_numpy(mat.astype(np.int32))
    else:
        a = torch.tensor(alpha, dtype=dtype)
        mat = ((m32.to(dtype) * a + m70.to(dtype) * (1 - a))
               * torch.tensor(256.0, dtype=dtype)).to(torch.int16) \
            .to(torch.int32)
    mat = mat.tolist()

    def correct(ci):
        m = mat[ci]
        acc = m[3] + m[0] * rF + m[1] * gF + m[2] * bF
        return _i16(torch.div(acc, 256, rounding_mode="floor"))

    corr = torch.stack([correct(0), correct(1), correct(2)])
    del rF, gF, bF
    lut = curve_lut(args["black_level"], args["white_level"], args["gamma"],
                    args["contrast"], dtype).to(dev)
    curved = lut[corr.clamp(0, 1023).long()]          # [c, y, x] over -2..
    del corr

    strength_x32 = int(np.clip(round(args["sharpen_strength"] * 32), 0, 255))
    uy = _avg(_avg(curved[:, :-2, 1:-1], curved[:, 2:, 1:-1]),
              curved[:, 1:-1, 1:-1])
    un = _avg(_avg(uy[:, :, :-2], uy[:, :, 2:]), uy[:, :, 1:-1])
    cc = curved[:, 2:-2, 2:-2]
    msk = cc - un[:, 1:-1, :]
    sharp = cc + torch.div(msk * strength_x32, 32, rounding_mode="floor")
    return sharp.clamp(0, 255).to(torch.uint8)

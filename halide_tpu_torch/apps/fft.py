"""fft: 2D complex FFT written in the DSL — radix-2 DIT with expression-level
twiddles and tuple-valued (re, im) stages
(reference: apps/fft/fft.h:47-58 fft2d_r2c/c2c — the reference's FFT is
likewise built from Funcs; this is the capability-parity c2c form)."""
from __future__ import annotations

import math

import numpy as np

import halide_tpu_torch as hl

from . import App, register


def _bitrev_expr(x, bits: int):
    e = hl.i32(0)
    for i in range(bits):
        e = e | (((x >> i) & 1) << (bits - 1 - i))
    return e


def _fft1d(src, n: int, axis_vars, axis: int, inverse: bool,
           name: str):
    """src: tuple-valued Func (re, im) over axis_vars; FFT along
    axis_vars[axis] of length n. Returns the final stage Func."""
    bits = int(math.log2(n))
    assert (1 << bits) == n, "power-of-two sizes only"
    vs = axis_vars
    xv = vs[axis]
    sign = 1.0 if inverse else -1.0

    def at(f, idx_expr, vi):
        args = list(vs)
        args[axis] = idx_expr
        return f[tuple(args)][vi]

    # bit-reversal permutation (indices clamped: value-level no-ops that
    # keep the interval analysis exact across stages)
    cur = hl.Func(f"{name}_rev")
    rev = _bitrev_expr(hl.clamp(xv, 0, n - 1), bits)
    args_rev = list(vs)
    args_rev[axis] = rev
    cur[tuple(vs)] = (src[tuple(args_rev)][0], src[tuple(args_rev)][1])
    cur.compute_root()

    for s in range(1, bits + 1):
        m = 1 << s
        half = m >> 1
        nxt = hl.Func(f"{name}_s{s}")
        j = xv % m
        upper = j >= half                 # second half of the butterfly
        jw = hl.select(upper, j - half, j)
        ang = (sign * 2.0 * math.pi / m) * hl.f32(jw)
        wr, wi = hl.cos(ang), hl.sin(ang)
        even_i = hl.clamp(hl.select(upper, xv - half, xv), 0, n - 1)
        odd_i = hl.clamp(hl.select(upper, xv, xv + half), 0, n - 1)
        er, ei = at(cur, even_i, 0), at(cur, even_i, 1)
        orr, oi = at(cur, odd_i, 0), at(cur, odd_i, 1)
        tr = wr * orr - wi * oi
        ti = wr * oi + wi * orr
        outr = hl.select(upper, er - tr, er + tr)
        outi = hl.select(upper, ei - ti, ei + ti)
        nxt[tuple(vs)] = (outr, outi)
        nxt.compute_root()
        cur = nxt
    if inverse:
        fin = hl.Func(f"{name}_norm")
        fin[tuple(vs)] = (cur[tuple(vs)][0] / float(n),
                          cur[tuple(vs)][1] / float(n))
        cur = fin
    return cur


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _bluestein1d(src, n: int, axis_vars, axis: int, inverse: bool,
                 name: str):
    """Arbitrary-length FFT via Bluestein's chirp-z transform
    (reference: apps/fft/fft.h handles non-pow2 factors with specialized
    radices; this route reuses the radix-2 engine on the zero-padded 2^k
    convolution):
        X_k = w_k * IFFT_M( FFT_M(x_n w_n) * FFT_M(b_n) ),
        w_n = exp(sign*i*pi*n^2/n), b = conj-chirp wrapped circularly,
        M = next_pow2(2n-1)."""
    m = 1
    while m < 2 * n - 1:
        m <<= 1
    vs = axis_vars
    xv = vs[axis]
    sign = 1.0 if inverse else -1.0

    def sub(f, idx_expr, vi):
        args = list(vs)
        args[axis] = idx_expr
        return f[tuple(args)][vi]

    def chirp(idx):
        # exp(sign*i*pi*idx^2/n); idx^2 mod 2n keeps the angle small/exact
        sq = (idx * idx) % (2 * n)
        ang = (sign * math.pi / n) * hl.f32(sq)
        return hl.cos(ang), hl.sin(ang)

    nc = hl.clamp(xv, 0, n - 1)
    wr, wi = chirp(nc)
    a = hl.Func(f"{name}_a")
    in_r = sub(src, nc, 0)
    in_i = sub(src, nc, 1)
    valid = xv < n
    a[tuple(vs)] = (hl.select(valid, in_r * wr - in_i * wi, 0.0),
                    hl.select(valid, in_r * wi + in_i * wr, 0.0))
    a.compute_root()

    b = hl.Func(f"{name}_b")
    # conj chirp at |folded| index, circularly wrapped: b[k]=cw(k) k<n,
    # b[m-k]=cw(k) 0<k<n, else 0
    fold = hl.select(xv < n, xv, m - xv)
    fr, fi = chirp(hl.clamp(fold, 0, n - 1))
    inb = hl.logical_or(xv < n, xv > m - n)
    b[tuple(vs)] = (hl.select(inb, fr, 0.0),
                    hl.select(inb, -fi, 0.0))
    b.compute_root()

    A = _fft1d(a, m, vs, axis, False, f"{name}_A")
    B = _fft1d(b, m, vs, axis, False, f"{name}_B")
    C = hl.Func(f"{name}_C")
    ar, ai = A[tuple(vs)][0], A[tuple(vs)][1]
    br, bi = B[tuple(vs)][0], B[tuple(vs)][1]
    C[tuple(vs)] = (ar * br - ai * bi, ar * bi + ai * br)
    C.compute_root()
    c = _fft1d(C, m, vs, axis, True, f"{name}_c")

    out = hl.Func(f"{name}_out")
    cr = sub(c, nc, 0)
    ci = sub(c, nc, 1)
    # an inverse transform normalizes by 1/n (the chirp sign only flips
    # the exponent; the internal IFFT's 1/m belongs to the convolution)
    scale = (1.0 / n) if inverse else 1.0
    out[tuple(vs)] = ((cr * wr - ci * wi) * scale,
                      (cr * wi + ci * wr) * scale)
    out.compute_root()
    return out


def _fft1d_any(src, n: int, axis_vars, axis: int, inverse: bool, name: str):
    if _is_pow2(n):
        return _fft1d(src, n, axis_vars, axis, inverse, name)
    return _bluestein1d(src, n, axis_vars, axis, inverse, name)


def _wrap_complex(src, name):
    x, y = hl.Var("x"), hl.Var("y")
    wrap = hl.Func(f"{name}_in")
    wrap[x, y] = (src[x, y][0], src[x, y][1]) if hasattr(src, "_defs") \
        else (src[x, y, 0], src[x, y, 1])
    return wrap, x, y


def fft2d(src, w: int, h: int, inverse: bool = False, name: str = "fft2d"):
    """2-D complex-to-complex FFT; any sizes (radix-2 for powers of two,
    Bluestein otherwise). (reference: apps/fft/fft.h:47-57 fft2d_c2c)"""
    wrap, x, y = _wrap_complex(src, name)
    fx = _fft1d_any(wrap, w, (x, y), 0, inverse, f"{name}_x")
    fy = _fft1d_any(fx, h, (x, y), 1, inverse, f"{name}_y")
    return fy


def fft2d_c2c(src, w: int, h: int, sign: int = -1, name: str = "c2c"):
    """Reference-signature c2c: sign=-1 forward, +1 inverse (the inverse is
    normalized by 1/(w*h) like the reference's usage comment)."""
    return fft2d(src, w, h, inverse=(sign > 0), name=name)


def fft2d_r2c(src, w: int, h: int, name: str = "r2c"):
    """Real -> half-spectrum complex: output x in [0, w/2], y in [0, h)
    (reference: apps/fft/fft.h:58 fft2d_r2c). Computed through the full
    c2c engine with a zero imaginary plane; the conjugate-symmetric half
    is simply not realized."""
    x, y = hl.Var("x"), hl.Var("y")
    wrap = hl.Func(f"{name}_re_in")
    wrap[x, y] = (src[x, y], 0.0)
    fx = _fft1d_any(wrap, w, (x, y), 0, False, f"{name}_x")
    fy = _fft1d_any(fx, h, (x, y), 1, False, f"{name}_y")
    return fy


def fft2d_c2r(src, w: int, h: int, name: str = "c2r"):
    """Half-spectrum complex -> real inverse: input is the r2c output
    (x in [0, w/2]); the missing half is reconstructed by conjugate
    symmetry X[k] = conj(X[(w-k) mod w, (h-j) mod h])
    (reference: apps/fft/fft.h:65 fft2d_c2r)."""
    x, y = hl.Var("x"), hl.Var("y")
    full = hl.Func(f"{name}_full")
    mirror_x = hl.clamp((w - x) % w, 0, w // 2)
    mirror_y = hl.clamp((h - y) % h, 0, h - 1)
    use_sym = x > w // 2
    xr = hl.clamp(hl.select(use_sym, mirror_x, x), 0, w // 2)
    yr = hl.clamp(hl.select(use_sym, mirror_y, y), 0, h - 1)
    full[x, y] = (src[xr, yr][0],
                  hl.select(use_sym, -src[xr, yr][1], src[xr, yr][1]))
    full.compute_root()
    fx = _fft1d_any(full, w, (x, y), 0, True, f"{name}_x")
    fy = _fft1d_any(fx, h, (x, y), 1, True, f"{name}_y")
    out = hl.Func(f"{name}_re")
    out[x, y] = fy[x, y][0]
    return out


@register("fft")
def build(width: int = 256, height: int = 256, **_ignored) -> App:
    x, y, c = hl.Var("x"), hl.Var("y"), hl.Var("c")
    inp = hl.ImageParam(hl.Float(32), 3, "input")   # (x, y, c=re/im)

    fwd = fft2d(inp, width, height, inverse=False, name="fwd")
    output = hl.Func("fft_out")
    output[x, y, c] = hl.mux(c, [fwd[x, y][0], fwd[x, y][1]])

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"input": rng.standard_normal(
            (2, height, width)).astype(np.float32)}

    def reference(input):
        z = input[0].astype(np.complex128) + 1j * input[1]
        F = np.fft.fft2(z)   # np [y, x]
        return np.stack([F.real, F.imag]).astype(np.float32)

    return App("fft", hl.Pipeline(output), [inp], make_inputs, reference,
               [width, height, 2], megapixels=width * height / 1e6,
               tolerance=1e-3, atol=1e-2)

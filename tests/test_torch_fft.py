"""The FFT surface (tests/test_fft.py) in both packages: c2c at sizes that
are not powers of two (Bluestein on x, radix-2 on y), its inverse round
trip, r2c's half spectrum and c2r's inverse of it, each built the same way
in the port (realized on the CPU) and in the JAX package, against numpy's
FFT at the tolerances of tests/test_fft.py (1e-3) and against each other
(1e-4: the two evaluate the same f32 butterflies, with other libms'
sin/cos and another summation order in the Bluestein convolution)."""
import numpy as np
import torch

import halide_tpu as hl
import halide_tpu_torch as ht
from halide_tpu.apps import fft as jfft
from halide_tpu_torch.apps import fft as tfft


def _input(m, name, a):
    inp = m.ImageParam(m.Float(32), a.ndim, name)
    inp.set(a if m is hl else torch.from_numpy(a))
    return inp


def _realize(m, f, sizes):
    kw = {"device": "cpu"} if m is ht else {}
    r = m.Pipeline(f).realize(sizes, **kw)
    bufs = list(r) if not hasattr(r, "to_numpy") else [r]
    return [np.asarray(b.to_numpy()) for b in bufs]


def _both(build):
    """build(m, fftmod) -> (realized buffers, numpy's) in each package."""
    got, want = build(ht, tfft)
    ref, _ = build(hl, jfft)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)
    return got, want


def test_c2c_non_power_of_two():
    w, h = 24, 16
    z = np.random.default_rng(0).standard_normal((2, h, w)).astype(
        np.float32)

    def build(m, mod):
        inp = _input(m, "fftnp_in", z)
        out = _realize(m, mod.fft2d_c2c(inp, w, h, sign=-1, name="np2"),
                       [w, h])
        return out, np.fft.fft2(z[0] + 1j * z[1])
    (re, im), ref = _both(build)
    np.testing.assert_allclose(re + 1j * im, ref, rtol=1e-3, atol=1e-3)


def test_c2c_inverse_roundtrip_non_pow2():
    w, h = 12, 8
    z = np.random.default_rng(1).standard_normal((2, h, w)).astype(
        np.float32)

    def build(m, mod):
        inp = _input(m, "fftrt_in", z)
        fwd = mod.fft2d_c2c(inp, w, h, sign=-1, name="rt_f")
        back = mod.fft2d_c2c(fwd, w, h, sign=+1, name="rt_b")
        return _realize(m, back, [w, h]), z
    (re, im), _ = _both(build)
    np.testing.assert_allclose(re, z[0], atol=1e-3)
    np.testing.assert_allclose(im, z[1], atol=1e-3)


def test_r2c_half_spectrum():
    w, h = 32, 16
    a = np.random.default_rng(2).standard_normal((h, w)).astype(np.float32)

    def build(m, mod):
        inp = _input(m, "fftr_in", a)
        f = mod.fft2d_r2c(inp, w, h, name="r2c_t")
        return _realize(m, f, [w // 2 + 1, h]), \
            np.fft.fft2(a)[:, :w // 2 + 1]
    (re, im), ref = _both(build)
    np.testing.assert_allclose(re + 1j * im, ref, rtol=1e-3, atol=1e-3)


def test_c2r_inverts_r2c():
    w, h = 16, 8
    a = np.random.default_rng(3).standard_normal((h, w)).astype(np.float32)

    def build(m, mod):
        inp = _input(m, "fftcr_in", a)
        half = mod.fft2d_r2c(inp, w, h, name="cr_f")
        back = mod.fft2d_c2r(half, w, h, name="cr_b")
        return _realize(m, back, [w, h]), a
    (out,), _ = _both(build)
    np.testing.assert_allclose(out, a, atol=1e-3)

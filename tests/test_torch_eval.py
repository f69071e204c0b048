"""eval_torch (the port's whole-array evaluator) against eval_jnp (the JAX
package's), through each package's Pipeline.realize on the CPU with no
tiling: the same pipeline built in both packages, the same numpy inputs made
from a seed. Integer cases compare bit for bit. Five float cases allow an
ulp (rtol 1e-6): pow and the other libm functions (the two libms differ by an
ulp or two) and float mod and the f32 lerps, whose a - b*floor(a/b) and
zero*(1-w) + one*w XLA's CPU backend may contract into fused multiply-adds.
The lerps with an integer result or a bool weight compare bit for bit."""
import numpy as np
import pytest
import torch

import halide_tpu as hl
import halide_tpu_torch as ht

W, H = 37, 23


def _inputs(seed, dtype, lo, hi):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        a = rng.uniform(lo, hi, size=(H, W)).astype(dtype)
        b = rng.uniform(lo, hi, size=(H, W)).astype(dtype)
    else:
        a = rng.integers(lo, hi, size=(H, W)).astype(dtype)
        b = rng.integers(lo, hi, size=(H, W)).astype(dtype)
    b.flat[::5] = 0          # zero divisors and zero operands
    return a, b


def _u16_ops(m, a, b, x, y):
    return ((a[x, y] + b[x, y]) * b[x, y] - a[x, y]) ^ (a[x, y] >> 3)


def _i32_divmod(m, a, b, x, y):
    return a[x, y] / b[x, y] + a[x, y] % b[x, y] * 7


def _u16_divmod(m, a, b, x, y):
    return a[x, y] / b[x, y] + a[x, y] % b[x, y]


def _f32_mod(m, a, b, x, y):
    return a[x, y] % m.cast(m.Float(32), b[x, y] + 3)


def _casts(m, a, b, x, y):
    # f32 -> i32 truncates toward zero; i32 -> u8 and i16 wrap
    i = m.cast(m.Int(32), a[x, y] * 1000.5)
    return (m.cast(m.Int(32), m.cast(m.UInt(8), i))
            + m.cast(m.Int(32), m.cast(m.Int(16), i * 3)))


def _select(m, a, b, x, y):
    return m.select(a[x, y] > b[x, y], a[x, y] - b[x, y],
                    a[x, y] < 100, b[x, y], a[x, y])


def _pow(m, a, b, x, y):
    return m.pow(a[x, y], 2.4) + m.pow(b[x, y] + 1.0, 1.0 / 2.4)


def _repeat_edge(m, a, b, x, y):
    e = m.repeat_edge(a)
    return e[x - 2, y + 3] + e[x + 4, y - 1] * 2 + e[2 * x - 5, y]


def _clamped_strided(m, a, b, x, y):
    return a[m.clamp(2 * x + 1, 0, W - 1), m.clamp(y - 4, 0, H - 1)] \
        - a[m.clamp(W - 1 - x, 3, W - 4), y]


def _gather(m, a, b, x, y):
    return a[m.cast(m.Int(32), b[x, y]) % W, y]


def _div_index(m, a, b, x, y):
    return a[x / 2, (y + 1) / 3] + a[(x + 3) / 4, y]


def _div_reads(m, a, b, x, y):
    """Div-indexed reads of a root Func realized over the footprint they
    need: the slice path (a narrow, a d-fold repeat, a narrow to the
    phase), including (x - 1) / 2 below the image's origin."""
    g = m.Func("g")
    g[x, y] = m.repeat_edge(a)[x, y] * 3 + m.repeat_edge(b)[x, y] % 5
    g.compute_root()
    return (g[x / 2, y] + g[(x + 1) / 2, y] * 2 - g[(x - 1) / 2, y]
            + g[x, y / 8] * 5 - g[(x + 7) / 8, y] + g[(x - 1) / 2, y / 8])


def _strided_reads(m, a, b, x, y):
    """Reads of a root Func at 2x, 3x + 1 (strided views: every read
    inside its realization) and -2x + 5 (a negative coefficient: an
    index_select); no product, so that f32 compares bit for bit."""
    g = m.Func("g")
    g[x, y] = m.repeat_edge(a)[x, y] + b[m.clamp(x, 0, W - 1), y]
    g.compute_root()
    return g[2 * x, y] + g[3 * x + 1, y] - g[-2 * x + 5, y]


def _lerp_f32(m, a, b, x, y):
    return m.lerp(a[x, y], b[x, y], a[x, y] * b[x, y])


def _lerp_u8_weight(m, a, b, x, y):
    return m.lerp(a[x, y] * 2.0, b[x, y] - 1.0,
                  m.cast(m.UInt(8), b[x, y] * 255.0))


def _lerp_bool_weight(m, a, b, x, y):
    return m.lerp(a[x, y], b[x, y], a[x, y] > b[x, y])


def _lerp_u16(m, a, b, x, y):
    # an integer result: computed in f32, rounded half to even
    return m.lerp(a[x, y], b[x, y], m.cast(m.Float(32), a[x, y] % 9) / 8.0)


def _math(m, a, b, x, y):
    v = m.abs(a[x, y])
    return (m.sqrt(v) + m.exp(-v) + m.floor(a[x, y]) + m.round(a[x, y] * 2)
            + m.log(v + 1.0))


CASES = {
    "u16_wrap": (_u16_ops, "uint16", 0, 1 << 16, 0),
    "i32_floor_divmod_zero": (_i32_divmod, "int32", -50, 50, 0),
    "u16_divmod_zero": (_u16_divmod, "uint16", 0, 300, 0),
    "f32_mod": (_f32_mod, "float32", -20.0, 20.0, 1e-6),
    "casts": (_casts, "float32", -40.0, 40.0, 0),
    "select": (_select, "int32", -300, 300, 0),
    "pow": (_pow, "float32", 0.0, 1.0, 1e-6),
    "repeat_edge": (_repeat_edge, "uint16", 0, 1 << 14, 0),
    "clamped_strided": (_clamped_strided, "int32", -1000, 1000, 0),
    "gather": (_gather, "uint16", 0, 1000, 0),
    "div_index": (_div_index, "int32", -1000, 1000, 0),
    "div_reads": (_div_reads, "int32", -1000, 1000, 0),
    "div_reads_u16": (_div_reads, "uint16", 0, 1 << 14, 0),
    "strided_reads": (_strided_reads, "int32", -1000, 1000, 0),
    "strided_reads_f32": (_strided_reads, "float32", -10.0, 10.0, 0),
    "lerp_f32": (_lerp_f32, "float32", 0.0, 1.0, 1e-6),
    "lerp_u8_weight": (_lerp_u8_weight, "float32", 0.0, 1.0, 1e-6),
    "lerp_bool_weight": (_lerp_bool_weight, "int32", -300, 300, 0),
    "lerp_u16": (_lerp_u16, "uint16", 0, 1 << 16, 0),
    "math": (_math, "float32", -4.0, 4.0, 1e-6),
}

_TYPES = {"uint16": "UInt(16)", "int32": "Int(32)", "float32": "Float(32)"}


def _realize(m, fn, dtype, a_np, b_np):
    t = eval("m." + _TYPES[dtype])
    a, b = m.ImageParam(t, 2, "a"), m.ImageParam(t, 2, "b")
    x, y = m.Var("x"), m.Var("y")
    f = m.Func("f")
    f[x, y] = fn(m, a, b, x, y)
    if m is ht:
        a.set(torch.from_numpy(a_np))
        b.set(torch.from_numpy(b_np))
        return m.Pipeline(f).realize([W, H], device="cpu").to_numpy()
    a.set(a_np)
    b.set(b_np)
    return np.asarray(m.Pipeline(f).realize([W, H]).to_numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_torch_matches_eval_jnp(case):
    fn, dtype, lo, hi, rtol = CASES[case]
    a, b = _inputs(7, dtype, lo, hi)
    ref = _realize(hl, fn, dtype, a, b)
    got = _realize(ht, fn, dtype, a, b)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    if rtol == 0:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol)


def test_u16_storage_and_compute_dtypes():
    from halide_tpu_torch.htypes import compute_dtype, torch_dtype, type_of
    assert torch_dtype(ht.UInt(16)) == torch.uint16
    assert compute_dtype(ht.UInt(16)) == torch.int32
    assert compute_dtype(ht.UInt(32)) == torch.int64
    assert compute_dtype(ht.Float(32)) == torch.float32
    assert torch_dtype(ht.BFloat(16)) == torch.bfloat16
    assert type_of(torch.uint16) == ht.UInt(16)
    assert type_of(np.dtype("int16")) == ht.Int(16)


def test_realize_without_a_card_raises():
    # device=None means the card; with none present nothing may carry on
    # on the CPU
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: realize runs there")
    x = ht.Var("x")
    f = ht.Func("f")
    f[x] = x * 2
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.Pipeline(f).realize([8])
    np.testing.assert_array_equal(
        ht.Pipeline(f).realize([8], device="cpu").to_numpy(),
        np.arange(8, dtype=np.int32) * 2)


@pytest.mark.parametrize("dtype,lo,hi", [("int32", -1000, 1000),
                                         ("uint16", 0, 1 << 14)])
def test_div_reads_take_the_slice_path(dtype, lo, hi, monkeypatch):
    """Div-indexed reads on a single var are slices plus a repeat, not the
    gather over the whole realization; the values equal eval_jnp's."""
    from halide_tpu_torch import eval_torch as et

    def no_gather(*_a, **_k):
        raise AssertionError("div-indexed read went through the gather")

    a, b = _inputs(3, dtype, lo, hi)
    ref = _realize(hl, _div_reads, dtype, a, b)
    monkeypatch.setattr(et, "_gather_read", no_gather)
    got = _realize(ht, _div_reads, dtype, a, b)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("c,k,view", [(2, 0, True), (3, 2, True),
                                      (-2, 30, False)])
def test_affine_reads_with_a_coefficient(c, k, view, monkeypatch):
    """A read at c x + k inside the realization: a strided view of the
    buffer for c = 2 and 3 (no index_select, the same storage), an
    index_select for a negative c; the values are the buffer's."""
    from halide_tpu_torch import eval_torch as et
    picks = []
    orig = torch.Tensor.index_select

    def spy(self, *a, **kw):
        picks.append(a)
        return orig(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "index_select", spy)
    P = torch.arange(3 * 40, dtype=torch.float32).reshape(3, 40)
    inp = ht.ImageParam(ht.Float(32), 2, "p")
    x, y = ht.Var("x"), ht.Var("y")
    ctx = et.Ctx(2, {"x": et.Axis("x", 0, 0, 12), "y": et.Axis("y", 1, 0, 3)},
                 {}, {id(inp): et.Realized((P,), (0, 0), "p")}, {}, "cpu")
    got = et.eval_array(inp[c * x + k, y], ctx)
    want = P[:, [c * i + k for i in range(12)]]
    assert torch.equal(got, want)
    assert (not picks) == view
    shares = got.untyped_storage().data_ptr() == \
        P.untyped_storage().data_ptr()
    assert shares == view


# ---------------------------------------------------------------------------
# saturating_cast and absd at and beyond the limits (camera_pipe's output
# stage and demosaic): the inputs hold the edge values first, then values
# drawn from a seed; absd pairs each element with a rolled copy.
# ---------------------------------------------------------------------------

IW, IH = 16, 8

EDGE_VALUES = {
    "float32": [np.nan, -np.inf, np.inf, -1e10, 1e10, -32769.0, -32768.5,
                -32768.0, -0.7, -0.0, 0.0, 0.4, 127.5, 254.5, 255.0, 255.5,
                255.9, 256.0, 300.0, 32767.0, 32767.5, 32768.0, 2147483520.0,
                2147483648.0, -2147483648.0, -2147483904.0, 4e9, -np.nan],
    "int32": [-(1 << 31), (1 << 31) - 1, -1, 0, 1, 127, 128, 255, 256, 1000,
              -1000, 65535, 65536],
    "uint16": [0, 1, 255, 256, 32767, 32768, 32769, 65535],
    "int16": [-32768, 32767, -1, 0, 1, 100, -100, -32767, 32766],
    "int8": [-128, 127, -1, 0, 1, 64, -64, -127, 126],
}

_ITYPES = {"float32": "Float(32)", "int32": "Int(32)", "uint16": "UInt(16)",
           "int16": "Int(16)", "int8": "Int(8)"}


def intrin_inputs(dtype, seed=5):
    """(a, b): IH x IW arrays of `dtype`, the edge values first."""
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        a = rng.uniform(-70000, 70000, IH * IW).astype(np.float32)
    else:
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max, IH * IW, endpoint=True,
                         dtype=np.int64).astype(dtype)
    edge = np.array(EDGE_VALUES[dtype]).astype(dtype)
    a[:len(edge)] = edge
    a = a.reshape(IH, IW)
    return a, np.roll(a, 7)


INTRIN_CASES = {
    "sat_f32_u8": (lambda m, a, b, x, y: m.saturating_cast(m.UInt(8),
                                                           a[x, y]),
                   "float32"),
    "sat_f32_i16": (lambda m, a, b, x, y: m.saturating_cast(m.Int(16),
                                                            a[x, y]),
                    "float32"),
    "sat_f32_i32": (lambda m, a, b, x, y: m.saturating_cast(m.Int(32),
                                                            a[x, y]),
                    "float32"),
    "sat_i32_u8": (lambda m, a, b, x, y: m.saturating_cast(m.UInt(8),
                                                           a[x, y]),
                   "int32"),
    "sat_u16_i16": (lambda m, a, b, x, y: m.saturating_cast(m.Int(16),
                                                            a[x, y]),
                    "uint16"),
    "absd_i16": (lambda m, a, b, x, y: m.absd(a[x, y], b[x, y]), "int16"),
    "absd_i8": (lambda m, a, b, x, y: m.absd(a[x, y], b[x, y]), "int8"),
    "absd_i16_in_u16_sum": (
        lambda m, a, b, x, y: m.absd(a[x, y], b[x, y])
        + m.absd(b[x, y], a[x, y]), "int16"),
}


def intrin_pipeline(m, case, a_np, b_np, tile=None, device="cpu"):
    """f[x, y] = the case's expression of a and b, tiled by `tile` (the
    stencil-group kernel's path) or not (whole-array)."""
    fn, dtype = INTRIN_CASES[case]
    t = eval("m." + _ITYPES[dtype])
    a, b = m.ImageParam(t, 2, "a"), m.ImageParam(t, 2, "b")
    x, y = m.Var("x"), m.Var("y")
    f = m.Func("f")
    f[x, y] = fn(m, a, b, x, y)
    if tile is not None:
        xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
        f.tile(x, y, xo, yo, xi, yi, tile[0], tile[1])
    if m is ht:
        a.set(torch.from_numpy(a_np).to(device))
        b.set(torch.from_numpy(b_np).to(device))
    else:
        a.set(a_np)
        b.set(b_np)
    return m.Pipeline(f)


def jax_intrin(case):
    """The JAX package's whole-array values of a case."""
    a, b = intrin_inputs(INTRIN_CASES[case][1])
    return np.asarray(intrin_pipeline(hl, case, a, b).realize([IW, IH])
                      .to_numpy())


@pytest.mark.parametrize("case", sorted(INTRIN_CASES))
def test_saturating_cast_and_absd_match_eval_jnp(case):
    a, b = intrin_inputs(INTRIN_CASES[case][1])
    ref = jax_intrin(case)
    got = intrin_pipeline(ht, case, a, b).realize(
        [IW, IH], device="cpu").to_numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)


def test_saturating_cast_edges_by_hand():
    """The reference's rule spelled out: NaN gives 0, the limits hold, and
    f32 2^31 saturates to the i32 maximum."""
    from halide_tpu_torch.eval_torch import saturating_cast
    v = torch.tensor([np.nan, -1.0, 0.5, 254.9, 255.5, 1e10, 2147483648.0,
                      -np.inf])
    u8 = saturating_cast(v, ht.Float(32), ht.UInt(8))
    assert u8.tolist() == [0, 0, 0, 254, 255, 255, 255, 0]
    i32 = saturating_cast(v, ht.Float(32), ht.Int(32))
    assert i32.tolist() == [0, -1, 0, 254, 255, (1 << 31) - 1, (1 << 31) - 1,
                            -(1 << 31)]
    w = torch.tensor([65535, 32768, 32767, 0], dtype=torch.int32)  # u16
    assert saturating_cast(w, ht.UInt(16), ht.Int(16)).tolist() == \
        [32767, 32767, 32767, 0]

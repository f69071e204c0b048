"""The intrinsics the port's evaluator and its stencil-group kernel take
beyond the arithmetic: bit counts (popcount, clz, ctz), division rounded
toward zero, recip, reinterpret, u64, random, and print / print_when /
require through the hooks. Each is held against the JAX package on the CPU
(whole-array, x64 on), on the same numpy inputs, bit for bit; the u64
pipeline also against numpy. The inputs hold the edge values first: 0, 1,
all ones, the sign bit, division by 0, by 1 and by -1 (the signed minimum
over -1 included).

Inside a tiled group (K1) the integer intrinsics, recip and reinterpret
are planned (no reject), and the plain version and the emitted source built
with the host C++ compiler equal the whole-array values; print, print_when,
require and random make the plan reject the group, which then runs
whole-array. The tests marked gpu run K1 on the card against its plain
version."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke as cs
import halide_tpu_torch as ht
import halide_tpu_torch.iroperator as ht_iroperator
from halide_tpu_torch.ops import group_kernel as gk

W, H = 16, 8
WIDTHS = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
          "uint64"]


def _jax():
    """The JAX package, imported by the tests that hold the port against it
    (the machine with the card has no JAX; the gpu tests import none)."""
    import halide_tpu
    return halide_tpu


def _int_inputs(dtype, seed=5):
    """(a, b): H x W arrays of `dtype`; a's first elements are 0, 1, the
    maximum, the minimum (the sign bit of a signed type), all ones (-1 or
    the sign bit of an unsigned type), 2, 3 and the second bit from the
    top; b is a rolled, with zeros, ones and all ones, and all ones under
    a's minimum."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(seed)
    a = rng.integers(info.min, info.max, W * H, endpoint=True, dtype=dtype)
    ones = -1 if info.min < 0 else info.max
    third = info.max // 2 + 1 if info.min == 0 else -1
    edge = [0, 1, info.max, info.min, third, 2, 3, 1 << (info.bits - 2)]
    a[:len(edge)] = [np.array(v).astype(dtype) for v in edge]
    b = np.roll(a, 7)
    b[::5] = 0
    b[1::7] = ones
    b[2::7] = 1
    b[3] = ones
    return a.reshape(H, W), b.reshape(H, W)


def _realize(m, pipe, sizes):
    if m is ht:
        return pipe.realize(sizes, device="cpu").to_numpy()
    return np.asarray(pipe.realize(sizes).to_numpy())


def _intrinsics(m, dtype, tile=None, device="cpu"):
    a, b = _int_inputs(dtype)
    if m is ht:
        a, b = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
    return cs.intrinsic_group(m, dtype, a, b, tile)


@pytest.mark.parametrize("dtype", WIDTHS)
def test_integer_intrinsics_match_eval_jnp(dtype):
    """Floor and round-to-zero division and modulo, popcount, clz, ctz,
    reinterpret between the signed and unsigned Type, and recip of the
    bits as a float, xor'ed together: bit for bit."""
    hl = _jax()
    want = _realize(hl, _intrinsics(hl, dtype), [W, H])
    got = _realize(ht, _intrinsics(ht, dtype), [W, H])
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)


def test_bit_counts_by_hand():
    """Counts follow the Type's bits, not the compute dtype's (u16 is
    computed in int32): clz(u16 1) is 15, ctz(0) the Type's bits."""
    from halide_tpu_torch.eval_torch import _bit_length, _popcount, \
        _unsigned_bits
    v = torch.tensor([0, 1, 0x8000, 0xFFFF], dtype=torch.int32)   # u16
    u = _unsigned_bits(v, ht.UInt(16))
    assert (16 - _bit_length(u, 16)).tolist() == [16, 15, 0, 0]
    assert _popcount(u).tolist() == [0, 1, 1, 16]
    w = _unsigned_bits(torch.tensor([-1, -(1 << 63), 0]), ht.UInt(64))
    assert _popcount(w).tolist() == [64, 1, 0]
    assert (64 - _bit_length(w, 64)).tolist() == [0, 0, 64]


def _u64_inputs(seed=3):
    """u64 a, b with 0, 1, 2^63 - 1, 2^63, 2^64 - 1, 2^63 + 1 first, b
    with zeros, ones, all ones and 2^63; f64 f with NaN, negatives, 2^63,
    2^64 and beyond, the infinities."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 64 - 1, W * H, endpoint=True, dtype=np.uint64)
    a[:8] = np.array([0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1, 2 ** 63 + 1,
                      5, 2 ** 32], dtype=np.uint64)
    b = np.roll(a, 3)
    b[::5] = 0
    b[1::6] = 1
    b[2::7] = 2 ** 64 - 1
    b[4] = 2 ** 63
    f = rng.uniform(-1e20, 4e19, W * H)
    f[:10] = [np.nan, -1.0, -0.5, 0.5, 2.0 ** 63, 2.0 ** 64, 3e19, np.inf,
              -np.inf, 9.2e18]
    return a.reshape(H, W), b.reshape(H, W), f.reshape(H, W)


def test_u64_matches_eval_jnp_and_numpy():
    """u64 held in int64: wrapping +, -, *; exact unsigned / and % with
    x/0 == x%0 == 0; unsigned min, max and compares; logical shifts, 0 for
    a count of 64 or more; absd; conversion to f64 and f32 from values of
    2^63 and up, and from f64, NaN and negatives giving 0, 2^64 and up the
    maximum (XLA's conversion)."""
    hl = _jax()
    a, b, f = _u64_inputs()
    pj, golden = cs.u64_pipeline(hl, a, b, f)
    pt, _ = cs.u64_pipeline(ht, torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(f))
    want = _realize(hl, pj, [W, H, 15])
    got = _realize(ht, pt, [W, H, 15])
    gold = golden(a, b, f)
    assert got.dtype == want.dtype == np.uint64
    for c in range(15):
        np.testing.assert_array_equal(got[c], want[c], err_msg=f"plane {c}")
        np.testing.assert_array_equal(got[c], gold[c], err_msg=f"plane {c}")


def test_u64_constants_and_storage():
    """A u64 constant of 2^63 and up is the same bits in int64, and a u64
    buffer reads and writes its values unchanged."""
    x = ht.Var("x")
    inp = ht.ImageParam(ht.UInt(64), 1, "inp")
    vals = np.array([0, 2 ** 63, 2 ** 64 - 1, 12345], dtype=np.uint64)
    inp.set(torch.from_numpy(vals))
    f = ht.Func("f")
    f[x] = ht.max(inp[x], ht.cast(ht.UInt(64), 2 ** 64 - 2)) \
        ^ ht.cast(ht.UInt(64), 1)
    got = ht.Pipeline(f).realize([4], device="cpu").to_numpy()
    np.testing.assert_array_equal(
        got, np.maximum(vals, np.uint64(2 ** 64 - 2)) ^ np.uint64(1))


@pytest.fixture
def rng_tags():
    """Both packages' counters of random calls, put back after the test."""
    from halide_tpu import iroperator as hl_iroperator
    saved = hl_iroperator._rng_counter[0], ht_iroperator._rng_counter[0]
    yield hl_iroperator
    hl_iroperator._rng_counter[0], ht_iroperator._rng_counter[0] = saved


def _saturating(m, src_np, dst):
    """f[x] = saturating_cast(dst, a[x]) over a 1-D input, realized."""
    code = {"i": "Int", "u": "UInt", "f": "Float"}[src_np.dtype.kind]
    a = m.ImageParam(getattr(m, code)(src_np.dtype.itemsize * 8), 1, "a")
    a.set(torch.from_numpy(src_np) if m is ht else src_np)
    x = m.Var("x")
    f = m.Func("f")
    f[x] = m.saturating_cast(dst(m), a[x])
    return _realize(m, m.Pipeline(f), [len(src_np)])


I64 = np.array([-5, 0, 2 ** 40, 2 ** 63 - 1, -2 ** 63], np.int64)
U64 = np.array([0, 5, 2 ** 40, 2 ** 63, 2 ** 64 - 1], np.uint64)


@pytest.mark.parametrize("src,dst,want", [
    (I64, "UInt(64)", [0, 0, 2 ** 40, 2 ** 63 - 1, 0]),
    (U64, "Int(64)", [0, 5, 2 ** 40, 2 ** 63 - 1, 2 ** 63 - 1]),
    (U64, "UInt(8)", [0, 5, 255, 255, 255]),
    (U64, "Int(32)", [0, 5] + [2 ** 31 - 1] * 3),
    (I64, "Int(64)", list(I64)),
    (I64, "Int(16)", [-5, 0, 32767, 32767, -32768]),
])
def test_saturating_cast_of_64_bits_matches_numpy(src, dst, want):
    """saturating_cast clamps the value read in its own Type. Held against
    numpy alone: the JAX package clips an integer source through int32
    whenever the target has 32 bits or more, and reads a u64 source as
    signed (ROADMAP queue 3), so a 64-bit source wraps before it clips
    there (2^40 gives 0)."""
    got = _saturating(ht, src, lambda m: eval("m." + dst))
    np.testing.assert_array_equal(got, np.array(want).astype(got.dtype))


@pytest.mark.parametrize("src,dst", [
    (np.array([np.nan, -1.0, 1e10, 2.0 ** 63, 2.0 ** 64, 1e30], np.float32),
     "UInt(64)"),
    (U64, "Float(32)"), (U64, "Float(64)")])
def test_saturating_cast_between_u64_and_float_matches_eval_jnp(src, dst):
    hl = _jax()
    want = _saturating(hl, src, lambda m: eval("m." + dst))
    got = _saturating(ht, src, lambda m: eval("m." + dst))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _random_pipeline(m, kind, seed):
    x, y = m.Var("x"), m.Var("y")
    f = m.Func("r")
    sd = {None: None, "const": 7, "expr": x + 3,
          "neg": m.cast(m.Int(32), -5)}[seed]
    fn = {"float": m.random_float, "uint": m.random_uint,
          "int": m.random_int}[kind]
    f[x, y] = fn(sd) if sd is not None else fn()
    return m.Pipeline(f)


@pytest.mark.parametrize("seed", [None, "const", "expr", "neg"])
@pytest.mark.parametrize("kind", ["float", "uint", "int"])
def test_random_matches_jax_bit_for_bit(kind, seed, rng_tags):
    """threefry2x32 keys from the tag, folded with the seed argument's first
    element, drawn over the evaluated shape: JAX's bits exactly. Both
    packages number their random calls from the same counter value (put
    back after the test)."""
    hl = _jax()
    rng_tags._rng_counter[0] = ht_iroperator._rng_counter[0] = 40
    want = _realize(hl, _random_pipeline(hl, kind, seed), [13, 7])
    got = _realize(ht, _random_pipeline(ht, kind, seed), [13, 7])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_threefry_known_answer():
    """The Random123 known-answer vector of Threefry-2x32 with 20 rounds:
    key (0, 0), counter (0, 0) -> (0x6b200159, 0x99ba4efe)."""
    from halide_tpu_torch.eval_torch import threefry2x32
    z = torch.zeros((), dtype=torch.int64)
    x1, x2 = threefry2x32(z, z, z, z)
    assert (int(x1), int(x2)) == (0x6b200159, 0x99ba4efe)


def _print_pipelines(m):
    """(pipeline, sizes) of print, print_when and require cases."""
    x, y = m.Var("x"), m.Var("y")
    f = m.Func("p")
    f[x] = m.print_expr(x * 2, "doubled", 3)
    g = m.Func("g")
    g[x, y] = m.print_when(x > y, m.cast(m.Float(32), x) * 0.5 + y, "w")
    h = m.Func("h")
    h[x, y] = m.print_expr(m.cast(m.UInt(16), x * 1000 + y), "u16")
    k = m.Func("k")
    k[x] = m.require(x < 3, x + 1, "msg")
    p = m.Param(m.Int(32), "rq")
    p.set(5)
    k2 = m.Func("k2")
    k2[x] = m.require(p > 10, x + p)
    ok = m.Func("ok")
    ok[x] = m.require(x < 10, x)
    return [(m.Pipeline(f), [4]), (m.Pipeline(g), [5, 3]),
            (m.Pipeline(h), [20, 2]), (m.Pipeline(k), [8]),
            (m.Pipeline(k2), [3]), (m.Pipeline(ok), [4])]


def test_print_and_require_messages_match_jax():
    """The same messages, in the same order, through set_custom_print and
    set_error_handler; the values pass through."""
    hl = _jax()
    got = {}
    for m in (hl, ht):
        msgs = []
        prev_p = m.set_custom_print(msgs.append)
        prev_e = m.set_error_handler(msgs.append)
        try:
            got[m] = (msgs, [_realize(m, p, s)
                             for p, s in _print_pipelines(m)])
        finally:
            m.set_custom_print(prev_p)
            m.set_error_handler(prev_e)
    assert got[ht][0] == got[hl][0]
    assert got[ht][0][0] == "[0, 2, 4, 6] doubled\n"
    assert got[ht][0][-1] == \
        "Requirement Failed: (1 of 1 lanes violate the condition)"
    for a, b in zip(got[ht][1], got[hl][1]):
        np.testing.assert_array_equal(a, b)


def test_require_raises_without_a_handler():
    x = ht.Var("x")
    f = ht.Func("f")
    f[x] = ht.require(x < 2, x)
    with pytest.raises(RuntimeError, match="Requirement Failed"):
        ht.Pipeline(f).realize([4], device="cpu")


def _host_build(plan, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the emitted source")
    cu, so = tmp_path / f"{plan.symbol}.cu", tmp_path / f"{plan.symbol}.so"
    cu.write_text(plan.source)
    r = subprocess.run(
        [gxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
         "-ffp-contract=off", "-I", str(gk._CSRC), "-o", str(so), str(cu)],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    fn = getattr(ctypes.CDLL(str(so)), f"host_run_{plan.symbol}")
    fn.argtypes = plan.arg_types
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("dtype", WIDTHS)
def test_intrinsics_in_a_group_plan_and_match(dtype, tmp_path):
    """The tiled group (8x4 tiles of the 16x8 output) is planned with no
    reject; its plain version and the g++ build of its source equal the
    whole-array values, which equal the JAX package's."""
    whole = _realize(ht, _intrinsics(ht, dtype), [W, H])
    pt = _intrinsics(ht, dtype, tile=(8, 4))
    before = sum(gk.rejects.values())
    gk.last_plan = None
    got = _realize(ht, pt, [W, H])
    assert sum(gk.rejects.values()) == before, dict(gk.rejects)
    assert gk.last_plan["func"] == "intrinsics"
    np.testing.assert_array_equal(got, whole)
    plan, inputs, rmins, _p, _r = gk.group_call(pt, "cpu")
    fn = _host_build(plan, tmp_path)
    host = torch.zeros(tuple(reversed(plan.extents)),
                       dtype=torch.from_numpy(got).dtype)
    assert fn(*gk.launch_args(plan, inputs, rmins, host)) == 0
    np.testing.assert_array_equal(host.numpy(), whole)
    hl = _jax()
    np.testing.assert_array_equal(
        whole, _realize(hl, _intrinsics(hl, dtype), [W, H]))


def test_intrinsic_operation_counts():
    """point_ops counts ctz, clz and the round-to-zero divisions as two
    integer operations, popcount and recip as one, a bit cast as none."""
    a = ht.ImageParam(ht.Int(32), 2, "a")
    x, y = ht.Var("x"), ht.Var("y")
    v = a[x, y]
    assert gk.point_ops(ht.popcount(v)) == (0, 1)
    assert gk.point_ops(ht.count_trailing_zeros(v)) == (0, 2)
    assert gk.point_ops(ht.div_round_to_zero(v, v)) == (0, 2)
    assert gk.point_ops(ht.reinterpret(ht.Float(32), v)) == (0, 0)
    assert gk.point_ops(ht.fast_inverse(ht.cast(ht.Float(32), v))) == (1, 0)


def _host_only(m, name, tile):
    """out[x, y] = a + an intrinsic the kernel does not take, tiled."""
    a_np = np.arange(W * H, dtype=np.int32).reshape(H, W)
    a = m.ImageParam(m.Int(32), 2, "a")
    a.set(torch.from_numpy(a_np) if m is ht else a_np)
    x, y = m.Var("x"), m.Var("y")
    v = a[x, y]
    body = {"print": lambda: m.print_expr(v, "v"),
            "print_when": lambda: m.print_when(v > 120, v),
            "require": lambda: m.require(v >= 0, v),
            "random": lambda: v + m.random_int()}[name]()
    out = m.Func("host_only")
    out[x, y] = body
    if tile is not None:
        xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
        out.tile(x, y, xo, yo, xi, yi, tile[0], tile[1])
    return m.Pipeline(out)


@pytest.mark.parametrize("name", ["print", "print_when", "require",
                                  "random"])
def test_whole_array_intrinsics_reject_the_group(name, rng_tags):
    """The plan rejects a group that holds print, print_when, require or
    random, with the reason counted; the group runs whole-array, with the
    values (and the message) of the untiled pipeline."""
    msgs = []
    prev = ht.set_custom_print(msgs.append)
    try:
        ht_iroperator._rng_counter[0] = 7
        want = _realize(ht, _host_only(ht, name, None), [W, H])
        ht_iroperator._rng_counter[0] = 7
        before = gk.rejects[f"intrinsic {name} in a group: it runs "
                            "whole-array"]
        got = _realize(ht, _host_only(ht, name, (8, 4)), [W, H])
    finally:
        ht.set_custom_print(prev)
    assert gk.rejects[f"intrinsic {name} in a group: it runs "
                      "whole-array"] == before + 1
    np.testing.assert_array_equal(got, want)
    if name.startswith("print"):
        assert len(msgs) == 2 and msgs[0] == msgs[1]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", WIDTHS)
def test_intrinsics_kernel_matches_plain_version_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pt = _intrinsics(ht, dtype, tile=(8, 4), device="cuda")
    launches = gk.launches
    out = pt.realize([W, H])
    assert gk.launches == launches + 1
    plan, inputs, rmins, params, _realz = gk.group_call(pt)
    plain = gk.run_plain(plan, inputs, rmins, params, inputs[0].device)
    torch.cuda.synchronize()
    assert torch.equal(out.data, plain)
    np.testing.assert_array_equal(
        out.to_numpy(), _realize(ht, _intrinsics(ht, dtype), [W, H]))


@pytest.mark.gpu
def test_u64_on_the_card_matches_numpy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b, f = _u64_inputs()
    pt, golden = cs.u64_pipeline(ht, *(torch.from_numpy(v).cuda()
                                       for v in (a, b, f)))
    np.testing.assert_array_equal(pt.realize([W, H, 15]).to_numpy(),
                                  golden(a, b, f))

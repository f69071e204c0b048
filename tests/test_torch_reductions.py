"""Inline reductions, rfactor and the contraction paths of dense-combine
updates, in both packages: each case is built the same way in the port
(realized on the CPU) and in the JAX package, and held against numpy and
against the other package. Integer results compare bit for bit; float
results within the stated tolerance (summation order differs: torch's
reductions against XLA's).

The cases of tests/test_reductions.py (`:9` sum, `:20` sum_with_where,
`:30` maximum_minimum, `:43` argmax, `:211` rfactor_sum, `:291` the unroll
mark), `test_reduce_over_func_output_types`
(tests/test_correctness_misc.py:111) and the rfactor error case
(tests/test_errors.py:120), and the port's own: an empty RDom, one RDom
reused in nested reductions, u8 sums that wrap, argmin/argmax ties over a
2-D RDom, the sum(e, helper) form, the reduce path the updates of the
slice's apps take, integer contractions, the precision guard, and (on the
card) the guard's effect on an f32 convolution and hgemm's bf16 rounding.
"""
import os

import numpy as np
import pytest
import torch

import halide_tpu_torch as ht
from halide_tpu_torch import eval_torch
from halide_tpu_torch import updates as tupdates


def _jax():
    """The JAX package, imported where a test compares with it (the tests
    marked gpu run where it is not installed)."""
    import halide_tpu
    return halide_tpu


def _jupdates():
    from halide_tpu import updates
    return updates


def _realize(m, f, sizes, **kw):
    if m is ht:
        kw.setdefault("device", "cpu")
    return f.realize(sizes, **kw)


def _np(r):
    if isinstance(r, (list, tuple)) or type(r).__name__ == "Realization":
        return [np.asarray(b.to_numpy()) for b in r]
    return np.asarray(r.to_numpy())


def _buf(m, a):
    return m.Buffer(torch.from_numpy(a)) if m is ht else m.Buffer(a)


# ---------------------------------------------------------------------------
# each case(m) builds and realizes in package m -> (outputs, numpy's)
# ---------------------------------------------------------------------------

def sum_inline(m):
    x = m.Var("x")
    r = m.RDom(0, 5)
    inp = _buf(m, np.arange(20, dtype=np.int32))
    f = m.Func()
    f[x] = m.sum(inp[x + r])
    return _realize(m, f, [10]), np.array(
        [np.arange(20)[i:i + 5].sum() for i in range(10)], np.int32)


def sum_with_where(m):
    x = m.Var("x")
    r = m.RDom(0, 10)
    r.where(r.x % 2 == 0)
    f = m.Func()
    f[x] = m.sum(r.x + x * 0)
    return _realize(m, f, [3]), np.array([20, 20, 20], np.int32)


def maximum_minimum(m):
    x = m.Var("x")
    r = m.RDom(0, 4)
    a = np.array([3, 1, 4, 1, 5, 9, 2, 6], dtype=np.int32)
    inp = _buf(m, a)
    f = m.Func()
    f[x] = m.maximum(inp[x + r]) - m.minimum(inp[x + r])
    return _realize(m, f, [5]), np.array(
        [a[i:i + 4].max() - a[i:i + 4].min() for i in range(5)], np.int32)


def argmax(m):
    x = m.Var("x")
    r = m.RDom(0, 8)
    inp = _buf(m, np.array([3, 1, 4, 1, 5, 9, 2, 6], dtype=np.int32))
    f = m.Func("am")
    am = m.argmax(inp[r.x + 0 * x])
    f[x] = (am[0], am[1])
    return _realize(m, f, [2]), [np.array([5, 5], np.int32),
                                 np.array([9, 9], np.int32)]


def rfactor_sum(m):
    x = m.Var("x")
    data = np.arange(64, dtype=np.int32)
    inp = _buf(m, data)
    r = m.RDom(0, 64)
    f = m.Func("total")
    f[x] = 0
    f[x] += inp[r.x]
    u = m.Var("u")
    ro, ri = m.RVar("ro"), m.RVar("ri")
    f.update().split(r.x, ro, ri, 8)
    f.update().rfactor(ro, u)
    return _realize(m, f, [1]), np.array([data.sum()], np.int32)


def reduce_over_func_output_types(m):
    x = m.Var("x")
    f = m.Func("rmax_f")
    f[x] = x
    f[x] *= 2
    r = m.RDom(0, 10, "rmax_r")
    g = m.Func("rmax_g")
    g[x] = m.maximum(f[r.x]) + x * 0
    return _realize(m, g, [2]), np.array([18, 18], np.int32)


def empty_rdom(m):
    """A zero-extent RDom leaves each reduction at its identity (the
    guard of eval_jnp.py:2865-2874)."""
    x = m.Var("x")
    r = m.RDom(0, 0)
    inp = _buf(m, np.arange(8, dtype=np.int32))
    f = m.Func("empty_red")
    f[x] = (m.sum(inp[x + r]), m.product(inp[x + r]),
            m.maximum(inp[x + r]), m.minimum(inp[x + r]))
    n = 4
    return _realize(m, f, [n]), [
        np.zeros(n, np.int32), np.ones(n, np.int32),
        np.full(n, np.iinfo(np.int32).min, np.int32),
        np.full(n, np.iinfo(np.int32).max, np.int32)]


def nested_same_rdom(m):
    """One RDom in an outer and an inner reduction: the inner binds its
    own points (fresh axis names a reduction)."""
    x = m.Var("x")
    r = m.RDom(0, 4)
    a = np.arange(1, 13, dtype=np.int32)
    inp = _buf(m, a)
    f = m.Func("nested")
    f[x] = m.sum(inp[r.x] * m.sum(inp[r.x + x]))
    return _realize(m, f, [6]), np.array(
        [a[:4].sum() * a[i:i + 4].sum() for i in range(6)], np.int32)


def u8_sum_wraps(m):
    """An hl.sum of u8 values accumulates in u8 and wraps; so does a
    product of i16."""
    x = m.Var("x")
    r = m.RDom(0, 7)
    a = (np.arange(40, dtype=np.int64) * 37 + 200).astype(np.uint8)
    b = (np.arange(40, dtype=np.int64) * 91 - 300).astype(np.int16)
    ia, ib = _buf(m, a), _buf(m, b)
    f = m.Func("wraps")
    f[x] = (m.sum(ia[x + r]), m.product(ib[x + r]))
    ws = [a[i:i + 7].astype(np.int64).sum() for i in range(30)]
    wp = [np.prod(b[i:i + 7].astype(np.int64)) for i in range(30)]
    return _realize(m, f, [30]), [
        (np.array(ws) % 256).astype(np.uint8),
        np.array(wp, np.int64).astype(np.int16)]


def _tie_data():
    """Values over a 5 x 4 RDom (rx, ry) for each of 3 x: several points
    share the maximum and the minimum."""
    rng = np.random.default_rng(7)
    return rng.integers(0, 3, size=(3, 4, 5)).astype(np.int32)  # [x,ry,rx]


def arg_ties_2d(m):
    """argmax/argmin over a 2-D RDom with ties: the first extreme point
    with RDom dim 0 (r.x) the most significant, i.e. the lowest r.x, then
    the lowest r.y (the JAX package flattens the RDom so, eval_jnp.py:
    2914-2948)."""
    x = m.Var("x")
    d = _tie_data()
    inp = _buf(m, d)                 # (rx, ry, x)
    r = m.RDom(0, 5, 0, 4, "tie")
    f = m.Func("ties")
    amax = m.argmax(inp[r.x, r.y, x])
    amin = m.argmin(inp[r.x, r.y, x])
    f[x] = (amax[0], amax[1], amax[2], amin[0], amin[1], amin[2])
    want = [[], [], [], [], [], []]
    for xi in range(3):
        flat = d[xi].T.reshape(-1)   # [rx, ry] flattened, rx significant
        for k, fn in ((0, np.argmax), (3, np.argmin)):
            i = int(fn(flat))
            want[k].append(i // 4)
            want[k + 1].append(i % 4)
            want[k + 2].append(flat[i])
    return _realize(m, f, [3]), [np.array(w, np.int32) for w in want]


def sum_with_helper(m):
    """sum(e, helper): the reduction as an update of a schedulable Func."""
    x = m.Var("x")
    r = m.RDom(0, 3)
    a = np.arange(10, dtype=np.float32) * 0.5
    inp = _buf(m, a)
    helper = m.Func("sum_helper")
    f = m.Func("with_helper")
    f[x] = m.sum(inp[x + r], helper) * 2.0
    return _realize(m, f, [7]), np.array(
        [a[i:i + 3].sum() * 2 for i in range(7)], np.float32)


CASES = [sum_inline, sum_with_where, maximum_minimum, argmax, rfactor_sum,
         reduce_over_func_output_types, empty_rdom, nested_same_rdom,
         u8_sum_wraps, arg_ties_2d, sum_with_helper]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_reduction_matches_jax_and_numpy(case):
    got, want = case(ht)
    ref, _ = case(_jax())
    got, ref = _np(got), _np(ref)
    wants = want if isinstance(want, list) else [want]
    gots = got if isinstance(got, list) else [got]
    refs = ref if isinstance(ref, list) else [ref]
    assert len(gots) == len(wants) == len(refs)
    for g, r, w in zip(gots, refs, wants):
        assert g.dtype == r.dtype and g.shape == r.shape
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, r, rtol=1e-6)
            np.testing.assert_allclose(g, w, rtol=1e-6)
        else:
            np.testing.assert_array_equal(g, r)
            np.testing.assert_array_equal(g, w)


_NAN_TIES = np.array([[1.0, 3.0, np.nan, 3.0, np.nan],
                      [2.0, 5.0, 5.0, -1.0, -1.0]], np.float32)


def _nan_ties(m, device="cpu"):
    """argmax and argmin of two rows with a NaN and ties, in package m (the
    port's on `device`)."""
    x = m.Var("x")
    r = m.RDom(0, 5)
    f = m.Func("nan_arg")
    if m is ht:
        inp = ht.Buffer(torch.from_numpy(_NAN_TIES).to(device))
    else:
        inp = _buf(m, _NAN_TIES)
    a, b = m.argmax(inp[r.x, x]), m.argmin(inp[r.x, x])
    f[x] = (a[0], b[0])
    return _np(_realize(m, f, [2], **({"device": device} if m is ht
                                      else {})))


def test_argmax_of_floats_with_nan_and_ties():
    """A NaN is the extreme value of both argmax and argmin, the first NaN
    wins, as jnp.argmax and torch.argmax do."""
    for g, r, w in zip(_nan_ties(ht), _nan_ties(_jax()), ([2, 1], [2, 3])):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, w)


def test_rfactor_requires_associative():
    """tests/test_errors.py:120 in both packages."""
    for m in (ht, _jax()):
        x = m.Var("x")
        f = m.Func("e_rf")
        r = m.RDom(0, 10)
        f[x] = 0
        f[x] = f[x] - r.x * f[x]
        with pytest.raises(m.CompileError):
            f.update().rfactor(r.x, m.Var("u"))


def test_public_surface_has_the_inline_reductions():
    for name in ("sum", "product", "maximum", "minimum", "argmax",
                 "argmin"):
        assert callable(getattr(ht, name)) and name in ht.__all__


def test_update_unroll_rvar_forces_unrolled_lowering(monkeypatch):
    """tests/test_reductions.py:291: update().unroll() on every RDom dim
    forces the unrolled lowering past the tap count (here 4, below the
    25 taps; the JAX package's HALIDE_TPU_UNROLL_TAPS, the port's
    `_UNROLL_TAPS`), in both packages alike."""
    monkeypatch.setenv("HALIDE_TPU_UNROLL_TAPS", "4")
    monkeypatch.setattr(tupdates, "_UNROLL_TAPS", 4)
    a = np.random.default_rng(0).random((12, 16), np.float32)
    outs = {}
    hl = _jax()
    for m, upd in ((ht, tupdates), (hl, _jupdates())):
        for mark in (False, True):
            x, y = m.Var("x"), m.Var("y")
            r = m.RDom(0, 5, 0, 5, "r")
            inp = m.ImageParam(m.Float(32), 2, "in_u")
            g = m.repeat_edge(inp)
            f = m.Func(f"unroll_spy_{int(mark)}")
            f[x, y] += g[x + r.x, y + r.y]
            if mark:
                f.update().unroll(r.x).unroll(r.y)
            inp.set(_buf(m, a))
            outs[(m, mark)] = _np(_realize(m, f, [16, 12]))
            path = upd._last_reduce_path.get(f.name)
            assert (path == "unrolled") == mark, (m.__name__, path)
    for key, v in outs.items():
        np.testing.assert_allclose(v, outs[(hl, False)], rtol=1e-5)


def _matmul(m, dtype, M, N, K, a, b, device="cpu"):
    i, j = m.Var("i"), m.Var("j")
    A = m.ImageParam(dtype, 2, "A")
    B = m.ImageParam(dtype, 2, "B")
    r = m.RDom(0, K, "rk")
    prod = m.Func("int_mm")
    prod[i, j] = m.cast(dtype, 0)
    prod[i, j] += A[i, r.x] * B[r.x, j]
    if m is ht:
        A.set(ht.Buffer(torch.from_numpy(a).to(device)))
        B.set(ht.Buffer(torch.from_numpy(b).to(device)))
        return _np(_realize(m, prod, [M, N], device=device))
    A.set(_buf(m, a))
    B.set(_buf(m, b))
    return _np(_realize(m, prod, [M, N]))


def _int_mm_data(np_t):
    """An integer matrix product past the einsum threshold, its values
    chosen to overflow: -> (M, N, K, a, b, the exact product wrapped to
    the type)."""
    M, N, K = 128, 96, 384
    rng = np.random.default_rng(5)
    info = np.iinfo(np_t)
    a = rng.integers(info.min, info.max, size=(K, M), dtype=np.int64) \
        .astype(np_t)
    b = rng.integers(info.min, info.max, size=(N, K), dtype=np.int64) \
        .astype(np_t)
    exact = (b.astype(np.int64) @ a.astype(np.int64)).astype(np_t)
    return M, N, K, a, b, exact


@pytest.mark.parametrize("np_t,t", [(np.int32, "Int"), (np.uint8, "UInt")])
def test_integer_einsum_update_is_bit_exact(np_t, t):
    """An integer product-sum over a grid past the einsum threshold takes
    the einsum path in both packages; the port's chunked int64 multiply
    and sum wraps to the type exactly as the JAX package's int32
    accumulation (values chosen to overflow)."""
    M, N, K, a, b, exact = _int_mm_data(np_t)
    hl = _jax()
    dt = (ht.Int if t == "Int" else ht.UInt)(8 * np.dtype(np_t).itemsize)
    jt = (hl.Int if t == "Int" else hl.UInt)(8 * np.dtype(np_t).itemsize)
    got = _matmul(ht, dt, M, N, K, a, b)
    want = _matmul(hl, jt, M, N, K, a, b)
    assert tupdates._last_reduce_path["int_mm"] == "einsum"
    assert _jupdates()._last_reduce_path["int_mm"] == "einsum"
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, exact)


def test_chunked_integer_contraction_matches_int64_product():
    """`_int_contract` with chunks smaller than the reduced axis equals one
    int64 product and sum."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(-50, 50, (7, 33)))
    b = torch.from_numpy(rng.integers(-50, 50, (33, 5)))
    old = eval_torch._INT_CHUNK
    try:
        eval_torch._INT_CHUNK = 7 * 5 * 4        # 4 of the 33 a chunk
        r = eval_torch._int_contract([a, b], [[0, 1], [1, 2]], [1], 3)
    finally:
        eval_torch._INT_CHUNK = old
    np.testing.assert_array_equal(r[:, 0, :].numpy(), (a @ b).numpy())


def test_precision_guard_sets_and_restores_the_flags(monkeypatch):
    """Inside `contract_precision` TF32 is off in cuBLAS and cuDNN and bf16
    reductions are full precision; after it the caller's settings are
    back. HT_PRECISION=default leaves them alone."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, dnn.allow_tf32,
             mm.allow_bf16_reduced_precision_reduction)
    try:
        mm.allow_tf32 = dnn.allow_tf32 = True
        mm.allow_bf16_reduced_precision_reduction = True
        monkeypatch.delenv("HT_PRECISION", raising=False)
        with eval_torch.contract_precision():
            assert not mm.allow_tf32 and not dnn.allow_tf32
            assert not mm.allow_bf16_reduced_precision_reduction
        assert mm.allow_tf32 and dnn.allow_tf32
        assert mm.allow_bf16_reduced_precision_reduction
        monkeypatch.setenv("HT_PRECISION", "default")
        with eval_torch.contract_precision():
            assert mm.allow_tf32 and dnn.allow_tf32
    finally:
        (mm.allow_tf32, dnn.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = saved


def _hgemm_product(device, M, N, K):
    """hgemm's bf16 product stage on the port past the einsum threshold,
    and the f32 product of its bf16-rounded operands (TF32 off) rounded to
    bf16 -> (got, want) as bf16 tensors."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((K, M), np.float32)).to(device)
    b = torch.from_numpy(rng.standard_normal((N, K), np.float32)).to(device)
    i, j = ht.Var("i"), ht.Var("j")
    A = ht.ImageParam(ht.Float(32), 2, "A")
    B = ht.ImageParam(ht.Float(32), 2, "B")
    r = ht.RDom(0, K, "rk")
    bf = ht.BFloat(16)
    prod = ht.Func("ABh")
    prod[i, j] = ht.cast(bf, 0.0)
    prod[i, j] += ht.cast(bf, A[i, r.x]) * ht.cast(bf, B[r.x, j])
    A.set(a)
    B.set(b)
    got = prod.realize([M, N], device=device).data
    assert tupdates._last_reduce_path["ABh"] == "einsum"
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = (b.bfloat16().float() @ a.bfloat16().float()).bfloat16()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return got, want


def _one_ulp_apart(got, want):
    """Equal, but for a few points one bf16 step apart (the two f32 sums
    may round apart where their orders differ)."""
    g, w = got.float(), want.float()
    step = (w.abs() * 2.0 ** -7).clamp(min=2.0 ** -126)
    assert ((g - w).abs() <= step).all()
    assert (g != w).float().mean().item() < 0.01


def test_hgemm_einsum_is_the_rounded_f32_product():
    """hgemm past the einsum threshold: its bf16 factors are upcast to f32
    (their products are exact there), contracted once in f32 and rounded
    to bf16 once, at the store; and the app matches the JAX package's
    within hgemm's tolerance."""
    from halide_tpu.apps import get as jget
    from halide_tpu_torch.apps import get as tget
    kw = dict(M=256, N=128, K=128)
    t = tget("hgemm")(**kw)
    data = t.make_inputs(0)
    t.bind(data, "cpu")
    got = t.realize("cpu").to_numpy()
    assert tupdates._last_reduce_path["ABh"] == "einsum"
    j = jget("hgemm")(**kw)
    j.bind(data)
    want = np.asarray(j.realize().to_numpy())
    assert _jupdates()._last_reduce_path["ABh"] == "einsum"
    np.testing.assert_allclose(got, want, rtol=t.tolerance, atol=t.atol)
    _one_ulp_apart(*_hgemm_product("cpu", **kw))


# ---------------------------------------------------------------------------
# the reduce path of each contraction update of the slice's apps
# ---------------------------------------------------------------------------

APP_PATHS = [
    ("conv_layer", dict(N=2, CI=32, CO=32, W=32, H=16)),
    ("depthwise_separable_conv", dict(N=2, CI=16, CO=8, CM=1, W=32, H=24)),
    ("depthwise_separable_conv", dict(N=1, CI=32, CO=16, CM=1, W=128,
                                      H=96)),
    ("sgemm", dict(M=128, N=96, K=64)),
    ("sgemm", dict(M=256, N=128, K=128)),
    ("nl_means", dict(width=48, height=40, patch_size=5, search_area=5)),
    ("gaussian_blur", dict(width=96, height=64)),
]


@pytest.mark.parametrize("name,kw", APP_PATHS)
def test_reduce_path_matches_jax(name, kw):
    """`updates._last_reduce_path` equals the JAX package's for every
    update of the app ("conv", "einsum", "unrolled" or "dense");
    gaussian_blur has no update (its sums are inline reductions, which
    record nothing in either package)."""
    from halide_tpu.apps import get as jget
    from halide_tpu_torch.apps import get as tget
    jupdates = _jupdates()
    tupdates._last_reduce_path.clear()
    jupdates._last_reduce_path.clear()
    t = tget(name)(**kw)
    data = t.make_inputs(0)
    t.bind(data, "cpu")
    t.realize("cpu")
    j = jget(name)(**kw)
    j.bind(data)
    j.realize()
    assert tupdates._last_reduce_path == jupdates._last_reduce_path
    if name == "conv_layer":
        assert tupdates._last_reduce_path == {"conv": "conv"}
    if name == "nl_means":
        assert tupdates._last_reduce_path == {
            "non_local_means_sum": "unrolled"}
    if kw.get("CI") == 32 and name.startswith("depthwise"):
        assert tupdates._last_reduce_path["pointwise_convolved"] == "einsum"
    if kw.get("K") == 128:
        assert tupdates._last_reduce_path["sgemm_AB"] == "einsum"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _conv_case(device, precision=None):
    """conv_layer's contraction (CI = 128 by 3 x 3: 1152 terms a point) on
    `device`, on inputs 1 + u 2^-12 and weights 1 + v 2^-12 (u, v in
    [0, 1)), whose information lies below TF32's 10-bit mantissa: TF32
    rounds every one to 1, an error of about 2^-12 x 1152 x (u + v) ~ 0.28
    a point, where f32 sums 1152 terms near 1 to within a few 1e-3.
    -> (max abs error against float64 numpy, reduce path)."""
    from halide_tpu_torch.apps import get as tget
    N, CI, CO, W, H = 1, 128, 64, 32, 16
    rng = np.random.default_rng(0)
    data = {"input": (1 + rng.random((N, H + 2, W + 2, CI)) * 2.0 ** -12)
            .astype(np.float32),
            "filter": (1 + rng.random((CI, 3, 3, CO)) * 2.0 ** -12)
            .astype(np.float32),
            "bias": np.zeros(CO, np.float32)}
    if precision is not None:
        os.environ["HT_PRECISION"] = precision
    try:
        app = tget("conv_layer")(N=N, CI=CI, CO=CO, W=W, H=H)
        app.bind(data, device)
        got = app.realize(device).to_numpy().astype(np.float64)
    finally:
        os.environ.pop("HT_PRECISION", None)
    inp = data["input"].astype(np.float64)
    flt = data["filter"].astype(np.float64)
    want = np.zeros((N, H, W, CO))
    for ky in range(3):
        for kx in range(3):
            want += np.einsum("nyxc,cd->nyxd", inp[:, ky:ky + H, kx:kx + W],
                              flt[:, ky, kx, :])
    return np.abs(got - want).max(), tupdates._last_reduce_path.get("conv")


def test_conv_case_is_accurate_on_the_cpu():
    """The CPU runs the case in full f32 (no TF32 there)."""
    err, path = _conv_case("cpu")
    assert path == "conv" and err < 0.02, err


@pytest.mark.gpu
def test_f32_convolution_runs_without_tf32_on_the_card():
    """cuDNN takes TF32 for f32 convolutions by default; under the port's
    guard the case is as accurate as f32 (error < 0.02), where
    HT_PRECISION=default, with torch's default TF32, is not (> 0.1); the
    process's flag is the caller's again after either."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True        # torch's default
    try:
        err, path = _conv_case("cuda")
        assert path == "conv"
        assert err < 0.02, err
        loose, _ = _conv_case("cuda", "default")
        assert loose > 0.1, loose
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.gpu
def test_hgemm_on_the_card_is_the_rounded_f32_product():
    """hgemm's bf16 product on the card: the f32 matmul of the upcast
    operands with TF32 off, rounded to bf16 (TF32 products would move a
    large share of the points by a bf16 step or more)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _one_ulp_apart(*_hgemm_product("cuda", 512, 256, 1024))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_conv_path_keeps_a_narrowing_cast():
    """A convolution-shaped sum of bf16-cast f32 reads: the JAX package's
    conv path reads the f32 arrays past the casts (its `_peel_call`), so
    the bf16 rounding is lost there; the port's takes the product with
    its casts elsewhere, and equals numpy's bf16-rounded sum."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((4, 12, 10)).astype(np.float32)   # (c, x, y)
    w = rng.standard_normal((3, 4, 5)).astype(np.float32)     # (k, c, o)
    x, y, o = ht.Var("x"), ht.Var("y"), ht.Var("o")
    A = ht.ImageParam(ht.Float(32), 3, "ca")
    W = ht.ImageParam(ht.Float(32), 3, "cw")
    r = ht.RDom(0, 4, 0, 3, "cr")
    bf = ht.BFloat(16)
    f = ht.Func("narrow_conv")
    f[o, x, y] = ht.f32(0)
    f[o, x, y] += ht.f32(ht.cast(bf, W[o, r.x, r.y])) * ht.f32(
        ht.cast(bf, A[x + r.y, y, r.x]))
    A.set(torch.from_numpy(a.transpose(0, 2, 1).copy()))    # (c, y, x)
    W.set(torch.from_numpy(w))
    got = f.realize([5, 10, 10], device="cpu").to_numpy()  # [y, x, o]
    assert tupdates._last_reduce_path["narrow_conv"] != "conv"

    def conv(a, w):
        out = np.zeros((10, 10, 5))
        for k in range(3):
            out += np.einsum("cxy,co->yxo", a[:, k:k + 10, :], w[k])
        return out

    def bf16(v):
        return torch.from_numpy(v).bfloat16().double().numpy()
    want = conv(bf16(a), bf16(w))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    hl = _jax()
    x, y, o = hl.Var("x"), hl.Var("y"), hl.Var("o")
    A = hl.ImageParam(hl.Float(32), 3, "ca")
    W = hl.ImageParam(hl.Float(32), 3, "cw")
    r = hl.RDom(0, 4, 0, 3, "cr")
    f = hl.Func("narrow_conv")
    f[o, x, y] = hl.f32(0)
    f[o, x, y] += hl.f32(hl.cast(hl.BFloat(16), W[o, r.x, r.y])) * hl.f32(
        hl.cast(hl.BFloat(16), A[x + r.y, y, r.x]))
    A.set(a.transpose(0, 2, 1).copy())
    W.set(w)
    ref = np.asarray(f.realize([5, 10, 10]).to_numpy())
    assert _jupdates()._last_reduce_path["narrow_conv"] == "conv"
    unrounded = conv(a.astype(np.float64), w.astype(np.float64))
    np.testing.assert_allclose(ref, unrounded, rtol=1e-5, atol=1e-5)
    assert np.abs(ref - want).max() > 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("np_t,t", [(np.int32, "Int"), (np.uint8, "UInt")])
def test_integer_einsum_update_on_the_card(np_t, t):
    """The integer einsum on the card, where torch has no integer matrix
    product: the chunked int64 multiply and sum, bit for bit the exact
    product wrapped to the type (the JAX package's result on the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, N, K, a, b, exact = _int_mm_data(np_t)
    dt = (ht.Int if t == "Int" else ht.UInt)(8 * np.dtype(np_t).itemsize)
    got = _matmul(ht, dt, M, N, K, a, b, device="cuda")
    assert tupdates._last_reduce_path["int_mm"] == "einsum"
    np.testing.assert_array_equal(got, exact)


@pytest.mark.gpu
def test_argmax_ties_and_nan_on_the_card():
    """torch.argmax/argmin on the card also give the first extreme point,
    a NaN winning (as on the CPU and as jnp): the NaN case, and ties over
    a 2-D RDom (the lowest r.x, then the lowest r.y)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for g, w in zip(_nan_ties(ht, "cuda"), ([2, 1], [2, 3])):
        np.testing.assert_array_equal(g, w)
    d = _tie_data()
    x = ht.Var("x")
    inp = ht.Buffer(torch.from_numpy(d).cuda())
    r = ht.RDom(0, 5, 0, 4, "tie")
    f = ht.Func("ties")
    amax, amin = ht.argmax(inp[r.x, r.y, x]), ht.argmin(inp[r.x, r.y, x])
    f[x] = (amax[0], amax[1], amin[0], amin[1])
    got = _np(f.realize([3], device="cuda"))
    for xi in range(3):
        flat = d[xi].T.reshape(-1)
        i, j = int(np.argmax(flat)), int(np.argmin(flat))
        assert [int(g[xi]) for g in got] == [i // 4, i % 4, j // 4, j % 4]

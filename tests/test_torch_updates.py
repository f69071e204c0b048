"""Update definitions on the port (halide_tpu_torch/updates.py) against the
JAX package, on the CPU: the update-definition cases of
tests/test_reductions.py, each built by the same code with either package
and realized from the same numpy inputs (made from a seed).

Integer cases compare bit for bit. Float cases allow rtol 1e-4 / atol 1e-5:
the scans go through the scan kernel's plain version on the port and through
the JAX package's Pallas scan (interpret mode) or XLA's rounds, which round
in another order. Every case is also held against its own numpy result, as
in tests/test_reductions.py."""
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import halide_tpu as jhl
import halide_tpu_torch as thl
from halide_tpu_torch.ops import group_kernel, scan_kernel


def _update_add(hl):
    x = hl.Var("x")
    r = hl.RDom(0, 6)
    f = hl.Func("acc")
    f[x] = 0
    f[x] += r.x * (x + 1)
    return f, [3], np.array([15, 30, 45])


def _implicit_init_sum(hl):
    x = hl.Var("x")
    r = hl.RDom(1, 4)
    f = hl.Func("implicit")
    f[x] += r.x + x
    return f, [2], np.array([10, 14])


def _histogram_scatter(hl):
    x = hl.Var("x")
    data = np.array([0, 1, 1, 2, 2, 2, 3, 3, 3, 3], dtype=np.uint8)
    inp = hl.Buffer(data)
    r = hl.RDom(0, 10)
    hist = hl.Func("hist")
    hist[x] = 0
    hist[hl.i32(inp[r.x])] += 1
    return hist, [4], np.array([1, 2, 3, 4])


def _histogram_2d_where(hl):
    x = hl.Var("x")
    img = np.random.default_rng(0).integers(0, 16, size=(8, 8),
                                            dtype=np.uint8)
    inp = hl.Buffer(img)
    r = hl.RDom(0, 8, 0, 8)
    r.where(r.x > r.y)
    hist = hl.Func("hist2")
    hist[x] = 0
    hist[hl.i32(inp[r.x, r.y])] += 1
    ref = np.zeros(16, np.int32)
    for yy in range(8):
        for xx in range(8):
            if xx > yy:
                ref[img[yy, xx]] += 1
    return hist, [16], ref


def _cumsum_scan(hl):
    x = hl.Var("x")
    r = hl.RDom(1, 9)
    inp = hl.Buffer(np.arange(10, dtype=np.int32))
    f = hl.Func("cum")
    f[x] = inp[x]
    f[r.x] = f[r.x - 1] + inp[r.x]
    return f, [10], np.cumsum(np.arange(10))


def _iir_scan_float(hl):
    x, yv = hl.Var("x"), hl.Var("y")
    H, W = 6, 8
    data = np.random.default_rng(1).standard_normal((H, W)).astype(
        np.float32)
    inp = hl.Buffer(data)
    a = 0.5
    r = hl.RDom(1, W - 1)
    f = hl.Func("iir")
    f[x, yv] = inp[x, yv]
    f[r.x, yv] = a * f[r.x - 1, yv] + (1 - a) * inp[r.x, yv]
    ref = data.astype(np.float64).copy()
    for i in range(1, W):
        ref[:, i] = a * ref[:, i - 1] + (1 - a) * data[:, i]
    return f, [W, H], ref


def _backward_scan(hl):
    x = hl.Var("x")
    inp = hl.Buffer(np.arange(8, dtype=np.int32))
    r = hl.RDom(0, 7)
    f = hl.Func("bwd")
    f[x] = inp[x]
    f[6 - r.x] = f[6 - r.x + 1] + inp[6 - r.x]
    res = np.arange(8)
    for i in range(6, -1, -1):
        res[i] = res[i + 1] + i
    return f, [8], res


def _min_scan(hl):
    x = hl.Var("x")
    data = np.array([5, 3, 8, 1, 9, 2], dtype=np.int32)
    inp = hl.Buffer(data)
    r = hl.RDom(1, 5)
    f = hl.Func("mins")
    f[x] = inp[x]
    f[r.x] = hl.min(f[r.x - 1], inp[r.x])
    return f, [6], np.minimum.accumulate(data)


def _update_at_fixed_point(hl):
    x = hl.Var("x")
    f = hl.Func("fixed")
    f[x] = x
    f[0] = 100
    return f, [4], np.array([100, 1, 2, 3])


def _multiple_updates(hl):
    x = hl.Var("x")
    f = hl.Func("multi")
    f[x] = 0
    f[x] += 5
    f[x] *= 2
    f[x] -= 3
    return f, [3], np.array([7, 7, 7])


def _sequential_fallback_general_update(hl):
    x = hl.Var("x")
    data = np.array([2, 0, 1, 2], dtype=np.int32)
    inp = hl.Buffer(data)
    r = hl.RDom(0, 4)
    f = hl.Func("seq")
    f[x] = 1
    f[hl.clamp(inp[r.x], 0, 3)] = f[hl.clamp(inp[r.x], 0, 3)] * 2 + r.x
    ref = np.ones(4, np.int64)
    for rr in range(4):
        e = np.clip(data[rr], 0, 3)
        ref[e] = ref[e] * 2 + rr
    return f, [4], ref


def _rdom_over_buffer(hl):
    x = hl.Var("x")
    inp = hl.Buffer(np.arange(6, dtype=np.int32))
    r = hl.RDom(inp)
    f = hl.Func("overbuf")
    f[x] = 0
    f[x] += inp[r.x]
    return f, [1], np.array([15])


def _product_update(hl):
    x = hl.Var("x")
    r = hl.RDom(1, 5)
    f = hl.Func("prod")
    f[x] = 1
    f[x] *= r.x
    return f, [2], np.array([120, 120])


def _slab_f(hl):
    x, y = hl.Var("x"), hl.Var("y")
    f = hl.Func("slab_f")
    f[x, y] = x + 10 * y
    f[3, y] = -1                      # const dim + axis
    r = hl.RDom([(2, 4)], "r")
    f[r.x, 5] += 100                  # rvar span + const
    ref = (np.arange(8)[None, :] + 10 * np.arange(8)[:, None]).astype(
        np.int32)
    ref[:, 3] = -1
    ref[5, 2:6] += 100
    return f, [8, 8], ref


def _slab_g(hl):
    x, y = hl.Var("x"), hl.Var("y")
    g = hl.Func("slab_g")
    g[x, y] = 0
    r2 = hl.RDom([(0, 8), (0, 6)], "r2")
    g[7 - r2.x, r2.y] = r2.x + r2.y   # reversed span x span
    gref = np.zeros((6, 8), np.int32)
    for rx in range(8):
        for ry in range(6):
            gref[ry, 7 - rx] = rx + ry
    return g, [8, 6], gref


def _masked_linear_scan(hl):
    x, y = hl.Var("x"), hl.Var("y")
    inp = hl.ImageParam(hl.Float(32), 2, "pin")
    a = np.random.default_rng(0).random((16, 32), np.float32)
    inp.set(hl.Buffer(a))
    r = hl.RDom(1, 15)
    r.where(r.x % 2 == 0)
    g = hl.Func("gm")
    g[x, y] = 0.0
    g[x, 0] = inp[x, 0]
    g[x, r.x] = 0.5 * g[x, r.x - 1] + inp[x, r.x]
    w = np.zeros((16, 32), np.float64)
    w[0] = a[0]
    for i in range(1, 16):
        w[i] = (0.5 * w[i - 1] + a[i]) if i % 2 == 0 else w[i]
    return g, [32, 16], w


def _sequential_long_rdom(hl):
    # a non-aligned self-read over 70 points: no array form, no outer loop
    x = hl.Var("x")
    data = np.random.default_rng(2).integers(0, 4, 70).astype(np.int32)
    inp = hl.Buffer(data)
    r = hl.RDom(0, 70)
    f = hl.Func("seq_long")
    f[x] = x
    f[hl.clamp(inp[r.x], 0, 3)] = \
        f[hl.clamp(inp[r.x] + 1, 0, 3)] * 3 + r.x
    ref = np.arange(4, dtype=np.int64)
    for rr in range(70):
        e, e1 = np.clip(data[rr], 0, 3), np.clip(data[rr] + 1, 0, 3)
        ref[e] = (ref[e1] * 3 + rr) % (1 << 32)
    return f, [4], ref.astype(np.uint32).astype(np.int32)


def _onehot_wide_target(hl):
    # 10 rdom points into 2000 bins: one whole-array pass per point
    x = hl.Var("x")
    data = np.random.default_rng(3).integers(0, 2000, 10).astype(np.int32)
    inp = hl.Buffer(data)
    r = hl.RDom(0, 10)
    f = hl.Func("onehot")
    f[x] = 1
    e = hl.clamp(inp[r.x], 0, 1999)
    f[e] = hl.max(f[e], r.x * 7)
    ref = np.ones(2000, np.int32)
    for rr in range(10):
        ref[data[rr]] = max(ref[data[rr]], rr * 7)
    return f, [2000], ref


def _general_scatter_add(hl):
    # 300 rdom points into 1500 u16 bins (a native scatter; sums wrap)
    x = hl.Var("x")
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 1500, 300).astype(np.int32)
    val = rng.integers(30000, 65535, 300).astype(np.uint16)
    ib, vb = hl.Buffer(idx), hl.Buffer(val)
    r = hl.RDom(0, 300)
    f = hl.Func("gscatter")
    f[x] = hl.u16(x % 7)
    f[hl.clamp(ib[r.x], 0, 1499)] += vb[r.x]
    ref = (np.arange(1500) % 7).astype(np.int64)
    for i, v in zip(idx, val):
        ref[i] += v
    return f, [1500], (ref % 65536).astype(np.uint16)


def _unroll_marked(hl, mark):
    # 25 taps: above the unroll threshold, so only the unroll() marks on
    # every RVar make the lowering unrolled (tests/test_reductions.py)
    x, y = hl.Var("x"), hl.Var("y")
    r = hl.RDom(0, 5, 0, 5, "r")
    inp = hl.ImageParam(hl.Float(32), 2, "in_u")
    a = np.random.default_rng(11).random((12, 16), np.float32)
    inp.set(hl.Buffer(a))
    g = hl.repeat_edge(inp)
    f = hl.Func(f"unroll_spy_{int(mark)}")
    f[x, y] += g[x + r.x, y + r.y]
    if mark:
        f.update().unroll(r.x).unroll(r.y)
    p = np.pad(a.astype(np.float64), ((0, 4), (0, 4)), mode="edge")
    ref = sum(p[j:j + 12, i:i + 16] for j in range(5) for i in range(5))
    return f, [16, 12], ref


def _dense_combine_where(hl):
    # 20 taps (> the unroll threshold) under a predicate: a dense reduction
    x = hl.Var("x")
    data = np.random.default_rng(6).integers(0, 100, (20, 5)).astype(
        np.int32)
    inp = hl.Buffer(data)
    r = hl.RDom(0, 20)
    r.where(r.x % 3 != 1)
    f = hl.Func("dwhere")
    f[x] = 0
    f[x] += inp[x, r.x]
    keep = np.arange(20) % 3 != 1
    return f, [5], data[keep].sum(axis=0)


def _u16_wraps(hl):
    # u16 is computed in int32 on the port: sums wrap at 2^16
    x = hl.Var("x")
    data = np.array([65530, 3, 65535, 7, 65000], dtype=np.uint16)
    inp = hl.Buffer(data)
    r = hl.RDom(0, 5)
    f = hl.Func("u16w")
    f[x] = hl.u16(65500 + x)
    f[x] += inp[r.x]
    f[hl.clamp(hl.i32(inp[r.x]) % 3, 0, 2)] += hl.u16(40000)
    ref = (65500 + np.arange(3) + data.astype(np.int64).sum())
    for v in data:
        ref[int(v) % 3] += 40000
    return f, [3], (ref % 65536).astype(np.uint16)


def _slab_free_rvar(hl):
    # a box write whose rvar is not in the LHS: reduced before the write
    x, y = hl.Var("x"), hl.Var("y")
    data = np.random.default_rng(7).integers(-9, 9, (6, 4)).astype(np.int32)
    inp = hl.Buffer(data)
    f = hl.Func("slabfree")
    f[x, y] = x * y
    r = hl.RDom(0, 6)
    f[x, 2] += inp[x, r.x]
    f[x, 1] = hl.max(f[x, 1], inp[x, r.x] * 3)
    ref = (np.arange(4)[None, :] * np.arange(3)[:, None]).astype(np.int32)
    ref[2] += data.sum(axis=0)
    ref[1] = np.maximum(ref[1], (data * 3).max(axis=0))
    return f, [4, 3], ref


def _scatter_set_permutation(hl):
    # overwrites at unique data-dependent positions, every other one masked
    x = hl.Var("x")
    perm = np.random.default_rng(8).permutation(12).astype(np.int32)
    pb = hl.Buffer(perm)
    r = hl.RDom(0, 12)
    r.where(r.x % 2 == 0)
    f = hl.Func("setperm")
    f[x] = -1
    f[hl.clamp(pb[r.x], 0, 11)] = r.x * 10
    ref = np.full(12, -1, np.int32)
    for i in range(0, 12, 2):
        ref[perm[i]] = i * 10
    return f, [12], ref


def _max_scan_3d_backward(hl):
    # a backward max scan along the middle dim of a 3-D int Func
    x, y, c = hl.Var("x"), hl.Var("y"), hl.Var("c")
    data = np.random.default_rng(9).integers(-99, 99, (2, 9, 5)).astype(
        np.int32)
    inp = hl.Buffer(data)
    r = hl.RDom(0, 8)
    f = hl.Func("maxscan3")
    f[x, y, c] = inp[x, y, c]
    f[x, 7 - r.x, c] = hl.max(f[x, 8 - r.x, c], inp[x, 7 - r.x, c])
    ref = np.maximum.accumulate(data[:, ::-1, :], axis=1)[:, ::-1, :]
    return f, [5, 9, 2], ref


def _int_linear_scan_2d(hl):
    # an int32 recurrence with a varying coefficient (a log-depth pair scan)
    x, y = hl.Var("x"), hl.Var("y")
    data = np.random.default_rng(10).integers(-5, 5, (4, 10)).astype(
        np.int32)
    inp = hl.Buffer(data)
    r = hl.RDom(1, 9)
    f = hl.Func("iscan")
    f[x, y] = inp[x, y]
    f[r.x, y] = (y + 2) * f[r.x - 1, y] - inp[r.x, y]
    ref = data.astype(np.int64).copy()
    for i in range(1, 10):
        ref[:, i] = (np.arange(4)[:, None][:, 0] + 2) * ref[:, i - 1] \
            - data[:, i]
    return f, [10, 4], ((ref + (1 << 31)) % (1 << 32) - (1 << 31)).astype(
        np.int32)


def _tuple_update(hl):
    # a two-value Func: a dense combine on one value, a product on the other
    x = hl.Var("x")
    r = hl.RDom(0, 20)
    data = np.random.default_rng(12).integers(1, 4, (20, 3)).astype(np.int32)
    inp = hl.Buffer(data)
    f = hl.Func("tuple_f")
    f[x] = (hl.i32(0), hl.i32(1))
    f[x] = (f[x][0] + inp[x, r.x], f[x][1] * inp[x, r.x])
    return f, [3], (data.sum(axis=0), np.prod(data, axis=0, dtype=np.int64)
                    .astype(np.int32))


def _extent_sized_rdom(hl):
    # rdom bounds from an input's extent, resolved at realize
    x = hl.Var("x")
    data = np.arange(12, dtype=np.int32) * 3
    inp = hl.ImageParam(hl.Int(32), 1, "ext_in")
    inp.set(hl.Buffer(data))
    r = hl.RDom(1, inp.width() - 5)
    f = hl.Func("extent_rdom")
    f[x] = inp[x]
    f[r.x] = f[r.x - 1] + inp[r.x]
    ref = data.copy()
    ref[:8] = np.cumsum(data[:8])      # r = 1 .. 7
    return f, [12], ref


CASES = {
    "update_add": _update_add,
    "implicit_init_sum": _implicit_init_sum,
    "histogram_scatter": _histogram_scatter,
    "histogram_2d_where": _histogram_2d_where,
    "cumsum_scan": _cumsum_scan,
    "iir_scan_float": _iir_scan_float,
    "backward_scan": _backward_scan,
    "min_scan": _min_scan,
    "update_at_fixed_point": _update_at_fixed_point,
    "multiple_updates": _multiple_updates,
    "sequential_fallback_general_update":
        _sequential_fallback_general_update,
    "rdom_over_buffer": _rdom_over_buffer,
    "product_update": _product_update,
    "slab_update_paths_f": _slab_f,
    "slab_update_paths_g": _slab_g,
    "masked_linear_scan": _masked_linear_scan,
    "onehot_wide_target": _onehot_wide_target,
    "general_scatter_add": _general_scatter_add,
    "dense_combine_where": _dense_combine_where,
    "u16_wraps": _u16_wraps,
    "slab_free_rvar": _slab_free_rvar,
    "scatter_set_permutation": _scatter_set_permutation,
    "max_scan_3d_backward": _max_scan_3d_backward,
    "int_linear_scan_2d": _int_linear_scan_2d,
    "tuple_update": _tuple_update,
    "extent_sized_rdom": _extent_sized_rdom,
}


@pytest.mark.parametrize("case", list(CASES))
def test_update_matches_jax_package(case):
    jf, sizes, golden = CASES[case](jhl)
    want = jf.realize(sizes)
    tf, _sizes, _golden = CASES[case](thl)
    got = tf.realize(sizes, device="cpu")
    if not isinstance(golden, tuple):         # one value
        want, got, golden = [want], [got], (golden,)
    for w, g, gold in zip(want, got, golden):
        w, g = np.asarray(w.to_numpy()), g.to_numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(g.astype(np.float64), gold,
                                       rtol=1e-4, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, gold)


def test_sequential_update_matches_numpy():
    """The fully general fallback (a loop over the rdom), against the numpy
    loop alone: the JAX package's `_sequential_update` cannot run this case
    (it broadcasts a (1,)-shaped value into a 0-d element and raises)."""
    f, sizes, golden = _sequential_long_rdom(thl)
    got = f.realize(sizes, device="cpu").to_numpy()
    np.testing.assert_array_equal(got, golden)


@pytest.mark.parametrize("mark", [False, True])
def test_unroll_marks_force_the_unrolled_lowering(mark):
    from halide_tpu_torch import updates
    f, sizes, golden = _unroll_marked(thl, mark)
    got = f.realize(sizes, device="cpu").to_numpy()
    path = updates._last_reduce_path.get(f.name)
    assert path == ("unrolled" if mark else "dense"), path
    jf, _s, _g = _unroll_marked(jhl, mark)
    want = np.asarray(jf.realize(sizes).to_numpy())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, golden, rtol=1e-5, atol=1e-5)


def test_updates_never_write_into_the_input_or_another_realization():
    """f's pure definition is a plain read of the bound input and of another
    Func's realization; its updates (a scan written in place, a slab, a
    scatter) must leave both as they were."""
    x, y = thl.Var("x"), thl.Var("y")
    data = np.random.default_rng(4).random((6, 10), np.float32)
    t_in = torch.from_numpy(data.copy())
    inp = thl.ImageParam(thl.Float(32), 2, "alias_in")
    inp.set(t_in)
    g = thl.Func("alias_g")
    g[x, y] = inp[x, y]
    g.compute_root()
    f = thl.Func("alias_f")
    f[x, y] = g[x, y]
    r = thl.RDom(1, 9)
    f[r.x, y] = 0.5 * f[r.x - 1, y] + f[r.x, y]
    f[0, y] = -1.0
    out = thl.Func("alias_out")
    out[x, y] = f[x, y] + g[x, y]
    got = out.realize([10, 6], device="cpu").to_numpy()
    np.testing.assert_array_equal(t_in.numpy(), data)
    want = data.astype(np.float64).copy()
    for i in range(1, 10):
        want[:, i] = 0.5 * want[:, i - 1] + data[:, i]
    want[:, 0] = -1.0
    np.testing.assert_allclose(got, want + data, rtol=1e-5, atol=1e-6)

    # the same with the update Func itself reading the input directly
    h = thl.Func("alias_h")
    h[x, y] = inp[x, y]
    h[r.x, y] = 0.5 * h[r.x - 1, y] + h[r.x, y]
    h.realize([10, 6], device="cpu")
    np.testing.assert_array_equal(t_in.numpy(), data)


def test_update_in_a_tiled_group_is_evaluated_whole_array():
    """A compute_at producer with an update that writes at r.x, not at its
    pure var x (a scan): the stencil-group plan rejects it with the JAX
    planner's reason (counted) and the group runs whole-array."""
    x, y = thl.Var("x"), thl.Var("y")
    xo, yo, xi, yi = thl.Var("xo"), thl.Var("yo"), thl.Var("xi"), \
        thl.Var("yi")
    data = np.arange(16 * 12, dtype=np.int32).reshape(12, 16)
    inp = thl.ImageParam(thl.Int(32), 2, "tg_in")
    inp.set(torch.from_numpy(data))
    p = thl.Func("tg_p")
    p[x, y] = inp[x, y]
    r = thl.RDom(1, 15)
    p[r.x, y] = p[r.x - 1, y] + p[r.x, y]
    c = thl.Func("tg_c")
    c[x, y] = p[x, y] * 2
    c.tile(x, y, xo, yo, xi, yi, 8, 4)
    p.compute_at(c, xo)
    before = sum(group_kernel.rejects.values())
    got = c.realize([16, 12], device="cpu").to_numpy()
    assert sum(group_kernel.rejects.values()) == before + 1
    assert group_kernel.rejects["member tg_p: non-aligned update write"]
    np.testing.assert_array_equal(got, 2 * np.cumsum(data, axis=1))


def test_parallel_rvar_of_non_associative_update_raises():
    x = thl.Var("x")
    r = thl.RDom(1, 9)
    f = thl.Func("nonassoc")
    f[x] = x
    f[r.x] = f[r.x - 1] * 2 + 1
    with pytest.raises(thl.CompileError, match="non-associative"):
        f.update().parallel(r.x)
    g = thl.Func("assoc")
    g[x] = 0
    g[x] += r.x
    g.update().parallel(r.x)          # an associative combine is allowed
    np.testing.assert_array_equal(g.realize([2], device="cpu").to_numpy(),
                                  [45, 45])


def test_constant_scan_takes_the_plain_version_on_the_cpu():
    before = dict(scan_kernel.launches)
    f, sizes, golden = _iir_scan_float(thl)
    got = f.realize(sizes, device="cpu").to_numpy()
    assert scan_kernel.launches == before
    np.testing.assert_allclose(got.astype(np.float64), golden, rtol=1e-4,
                               atol=1e-5)


def test_the_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import halide_tpu_torch, halide_tpu_torch.updates\n"
        "from halide_tpu_torch.ops import group_kernel, rowhist_kernel, "
        "scan_kernel\n"
        "from halide_tpu_torch.apps import load_all\n"
        "load_all()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'halide_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       cwd=Path(__file__).resolve().parents[1])
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# the scatter and the sequential loop keep their indices on the card: no
# boolean mask, no read-back of an index (held against what they gave
# before, and against numpy)
# ---------------------------------------------------------------------------

def _scatter_masked(cur, op, idx, vals, t):
    """The scatter as it was: out-of-bounds index tuples dropped with a
    boolean mask (a read-back on the card)."""
    from halide_tpu_torch.eval_torch import _wrap
    valid = flat = None
    for k, ix in enumerate(idx):
        ix = ix.to(torch.int64)
        ok = (ix >= 0) & (ix < cur.shape[k])
        valid = ok if valid is None else valid & ok
        flat = ix if flat is None else flat * cur.shape[k] + ix
    flat = flat[valid]
    v = vals.expand(valid.shape)[valid]
    view = cur.view(-1)
    if op == "set":
        view[flat] = v
    elif op == "add":
        view.index_put_((flat,), v, accumulate=True)
    elif op == "sub":
        view.index_put_((flat,), torch.zeros_like(v) - v, accumulate=True)
    else:
        view.scatter_reduce_(0, flat, v, {"mul": "prod", "min": "amin",
                                          "max": "amax"}[op])
    if t.is_uint() and t.bits in (16, 32):
        cur.copy_(_wrap(cur, t))


@pytest.mark.parametrize("op", ["set", "add", "sub", "mul", "min", "max"])
@pytest.mark.parametrize("dtype", ["int32", "uint16", "float32"])
def test_scatter_drops_out_of_bounds_writes_as_before(op, dtype):
    from halide_tpu_torch import updates
    from halide_tpu_torch.htypes import compute_dtype
    t = {"int32": thl.Int(32), "uint16": thl.UInt(16),
         "float32": thl.Float(32)}[dtype]
    rng = np.random.default_rng(8)
    shape = (6, 9)                       # tensor axes: dim 1, dim 0
    cur0 = torch.from_numpy(rng.integers(0, 50, shape)).to(compute_dtype(t))
    if op == "set":                      # distinct targets: no write order
        cells = rng.permutation(8 * 11)[:40]
        i0, i1 = cells % 11 - 1, cells // 11 - 1
    else:
        i0 = rng.integers(-2, 11, (5, 8))
        i1 = rng.integers(-1, 8, (5, 8))
    idx = (torch.from_numpy(i1), torch.from_numpy(i0))
    vals = torch.from_numpy(rng.integers(1, 4, idx[0].shape)).to(
        compute_dtype(t))
    got, want = cur0.clone(), cur0.clone()
    updates._scatter_into(got, op, idx, vals, t)
    _scatter_masked(want, op, idx, vals, t)
    assert not torch.equal(want, cur0)   # some writes were in bounds
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "min", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_scatter_dropped_combines_leave_element_zero_as_it_was(op, dtype):
    """A dropped combine writes the op's no-op value into element 0: what
    is there (-0.0, NaN, the type's extremes) stays bit for bit, as under
    the masked scatter."""
    from halide_tpu_torch import updates
    t = thl.Float(32) if dtype == torch.float32 else thl.Int(32)
    if dtype == torch.float32:
        firsts = [-0.0, math.nan, math.inf, -math.inf, 0.0]
    else:
        firsts = [torch.iinfo(dtype).max, torch.iinfo(dtype).min, 0, -1]
    for first in firsts:
        cur0 = torch.tensor([[first, 3, 4], [5, 6, 7]], dtype=dtype)
        # every write out of bounds but the one at (1, 2)
        idx = (torch.tensor([-1, 2, 0, 1, 0]), torch.tensor([0, 1, 3, 2, -4]))
        vals = torch.full((5,), 2 if op == "min" else 9, dtype=dtype)
        got, want = cur0.clone(), cur0.clone()
        updates._scatter_into(got, op, idx, vals, t)
        _scatter_masked(want, op, idx, vals, t)
        assert not torch.equal(want[1:], cur0[1:])
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _sequential_dropping(hl):
    """A 2-D data-dependent update under a predicate, with targets outside
    the Func (dropped): the sequential loop."""
    x, y = hl.Var("x"), hl.Var("y")
    data = np.random.default_rng(9).integers(-2, 7, 40).astype(np.int32)
    inp = hl.Buffer(data)
    r = hl.RDom(0, 40)
    r.where(r.x % 3 != 1)
    f = hl.Func("seq_drop")
    f[x, y] = x + 10 * y
    f[x, hl.clamp(inp[r.x], -2, 6)] = \
        f[x, hl.clamp(inp[r.x] + 1, 0, 4)] * 2 + r.x - x
    ref = (np.arange(3)[None, :] + 10 * np.arange(5)[:, None]).astype(
        np.int64)
    for rr in range(40):
        e = data[rr]
        if rr % 3 == 1 or not 0 <= e < 5:
            continue
        ref[e] = ref[np.clip(e + 1, 0, 4)] * 2 + rr - np.arange(3)
    return f, [3, 5], ref.astype(np.int32)


@pytest.mark.parametrize("case", ["sequential_dropping", "long_rdom"])
def test_sequential_update_keeps_indices_on_the_device(case, monkeypatch):
    """The loop reads no index back (an out-of-bounds write is clamped into
    range and writes the old value back); same values as numpy."""
    from halide_tpu_torch import updates
    build = {"sequential_dropping": _sequential_dropping,
             "long_rdom": _sequential_long_rdom}[case]
    calls = []
    orig = updates._sequential_update

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(updates, "_sequential_update", spy)
    monkeypatch.setattr(torch.Tensor, "__int__", lambda self: pytest.fail(
        "an index was read back to the host"))
    f, sizes, golden = build(thl)
    got = f.realize(sizes, device="cpu").to_numpy()
    assert calls
    np.testing.assert_array_equal(got, golden)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["general_scatter_add",
                                  "scatter_set_permutation",
                                  "sequential_dropping",
                                  "sequential_fallback_general_update"])
def test_scatter_and_sequential_loop_do_not_sync(case, monkeypatch):
    """On the card, the scatter and the sequential loop run under
    torch.cuda.set_sync_debug_mode("error"): any read-back raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from halide_tpu_torch import updates
    entered = []

    def no_sync(name):
        orig = getattr(updates, name)

        def run(*a, **k):
            entered.append(name)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return orig(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        monkeypatch.setattr(updates, name, run)

    no_sync("_scatter_into")
    no_sync("_sequential_update")
    build = dict(CASES, sequential_dropping=_sequential_dropping)[case]
    f, sizes, golden = build(thl)
    got = f.realize(sizes).to_numpy()
    assert entered
    np.testing.assert_array_equal(got, golden)

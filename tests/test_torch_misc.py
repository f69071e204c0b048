"""The slice-1 cases of tests/test_correctness_misc.py in both packages:
compute_with (`:10`, `:235`, `:273`, `:321`), the mirror and repeat
boundary conditions (`:49`), a tuple update (`:64`), realize into a buffer
with a non-zero min (`:89`), the parallel() RVar proof (`:153`), a clamped
strided read (`:178`) and a clamp whose span lies wholly outside the range
(`:333`). Each is built the same way in the port (realized on the CPU) and
in the JAX package, and held against numpy and against each other, bit for
bit. The JAX case at `:273` also round-trips the pipeline through its
serializer, which the port does not have; the rest of it is here."""
import numpy as np
import pytest

import halide_tpu as hl
import halide_tpu_torch as ht

from test_torch_basics import _np, _realize


def _both(case):
    """case(m) in each package -> (port outputs, JAX outputs), as lists."""
    got, ref = _np(case(ht)), _np(case(hl))
    return (got if isinstance(got, list) else [got],
            ref if isinstance(ref, list) else [ref])


def _check(case, *want):
    got, ref = _both(case)
    assert len(got) == len(ref) == len(want)
    for g, r, w in zip(got, ref, want):
        assert g.dtype == r.dtype, (g.dtype, r.dtype)
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, w)


def test_compute_with_semantics_preserved():
    def case(m):
        x, y = m.Var("x"), m.Var("y")
        a, b, c = m.Func("cw_a"), m.Func("cw_b"), m.Func("cw_c")
        a[x, y] = x + y
        b[x, y] = x * y
        a.compute_root()
        b.compute_root()
        a.compute_with(b, x)
        c[x, y] = a[x, y] + b[x, y]
        return _realize(m, c, [4, 4])
    xs, ys = np.arange(4), np.arange(4)[:, None]
    _check(case, xs + ys + xs * ys)


def test_compute_with_forms_one_fused_group():
    """The siblings ix and iy form one compute_with clique in both
    packages' graphs (the port's `_fusion_cliques`; the JAX package lowers
    the clique under one joint barrier), and the values agree."""
    from halide_tpu_torch.pipeline import _fusion_cliques, gather_graph
    funcs = {}

    def case(m):
        x, y = m.Var("x"), m.Var("y")
        src = m.Func("cwf_src")
        src[x, y] = m.f32(x) * 2.0 + y
        src.compute_root()
        ix, iy = m.Func("cwf_ix"), m.Func("cwf_iy")
        ix[x, y] = src[x + 1, y] - src[x - 1, y]
        iy[x, y] = src[x, y + 1] - src[x, y - 1]
        ix.compute_root()
        iy.compute_root()
        ix.compute_with(iy, x)
        out = m.Func("cwf_out")
        out[x, y] = ix[x, y] * iy[x, y]
        funcs[m] = out
        return _realize(m, out, [4, 3])

    def sx(xx, yy):
        return np.float32(xx) * np.float32(2) + np.float32(yy)
    xs, ys = np.arange(4)[None, :], np.arange(3)[:, None]
    _check(case, (sx(xs + 1, ys) - sx(xs - 1, ys))
           * (sx(xs, ys + 1) - sx(xs, ys - 1)))
    cliques = _fusion_cliques(gather_graph([funcs[ht]]))
    assert sorted({tuple(sorted(f.name for f in c))
                   for c in cliques.values()}) == [("cwf_ix", "cwf_iy")]


@pytest.mark.parametrize("align", ["none", "start", "end", "no_align",
                                   "per_dim"])
def test_compute_with_align_variants(align):
    """AlignStart/AlignEnd/NoAlign with siblings over different extents:
    the values are the same whatever the alignment (each stage computes
    its own box), and the schedule records it."""
    def strategy(m):
        las = m.LoopAlignStrategy
        return {"none": None, "start": las.AlignStart, "end": las.AlignEnd,
                "no_align": las.NoAlign,
                "per_dim": {"x": las.AlignStart, "y": las.AlignEnd}}[align]
    recs = {}

    def case(m):
        x, y = m.Var("x"), m.Var("y")
        a, b, c = m.Func("cwa_a"), m.Func("cwa_b"), m.Func("cwa_c")
        a[x, y] = x + y
        b[x, y] = x * y
        a.compute_root()
        b.compute_root()
        a.compute_with(b, x, align=strategy(m))
        c[x, y] = a[x + 1, y] + b[x, y + 1]
        recs[m] = a._defs[0].schedule.fused_with[0]
        return _realize(m, c, [5, 3])
    xs, ys = np.arange(5), np.arange(3)[:, None]
    _check(case, (xs + 1 + ys) + xs * (ys + 1))
    for m in (hl, ht):
        s = strategy(m)
        want = (m.LoopAlignStrategy.Auto if s is None
                else s if isinstance(s, m.LoopAlignStrategy) else s["x"])
        assert recs[m][1] == "x" and recs[m][2]["x"] is want


def test_compute_with_rejects_bad_align_values():
    for m in (hl, ht):
        x = m.Var("x")
        f, g = m.Func("cwa_f"), m.Func("cwa_g")
        f[x] = x
        g[x] = x * 2
        f.compute_root()
        g.compute_root()
        with pytest.raises(m.CompileError, match="align"):
            f.compute_with(g, x, align="Sideways")
        with pytest.raises(m.CompileError, match="align"):
            f.compute_with(g, x, align={"nope": None})


def test_compute_with_rejects_dependent_stages():
    for m in (hl, ht):
        x = m.Var("x")
        a, b = m.Func("cwd_a"), m.Func("cwd_b")
        a[x] = x * 2
        b[x] = a[x] + 1
        a.compute_root()
        b.compute_root()
        a.compute_with(b, x)
        with pytest.raises(m.CompileError, match="independent"):
            _realize(m, b, [4])


def test_boundary_mirror_and_repeat():
    def case(m):
        x = m.Var("x")
        b = m.Buffer(np.array([1, 2, 3, 4], np.int32))
        mi, r, mint = (m.mirror_image(b), m.repeat_image(b),
                       m.mirror_interior(b))
        f = m.Func("bc_probe")
        f[x] = m.Tuple(mi[x - 2], r[x - 2], mint[x - 2])
        return _realize(m, f, [8])
    _check(case, [2, 1, 1, 2, 3, 4, 4, 3], [3, 4, 1, 2, 3, 4, 1, 2],
           [3, 2, 1, 2, 3, 4, 3, 2])


def test_tuple_update():
    def case(m):
        x = m.Var("x")
        f = m.Func("tu")
        r = m.RDom(0, 5, "tur")
        f[x] = (0, 1.0)
        f[x] = (f[x][0] + r.x, f[x][1] * 2.0)
        return _realize(m, f, [2])
    _check(case, np.array([10, 10], np.int32),
           np.array([32.0, 32.0], np.float32))


def test_realize_into_shifted_buffer():
    outs = []
    for m in (ht, hl):
        x = m.Var("x")
        f = m.Func("shift_f")
        f[x] = x * x
        dst = m.Buffer(type=m.Int(32), sizes=[4], mins=[10])
        if m is ht:
            m.Pipeline(f).realize(dst=dst, device="cpu")
        else:
            f.realize(dst=dst)
        outs.append(np.asarray(dst.to_numpy()))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], [100, 121, 144, 169])


def test_parallel_rvar_requires_proof():
    """parallel() on an RVar whose update reads other iterations' results
    raises in both packages; with atomic() a commutative += is accepted
    and gives the sum."""
    for m in (hl, ht):
        x = m.Var("x")
        f = m.Func("prv")
        r = m.RDom(0, 10, "prv_r")
        f[x] = 0
        f[x] = m.select(r.x > 2, f[x] * 2 + r.x, f[x])
        with pytest.raises(m.CompileError):
            f.update().parallel(r.x)

    def case(m):
        x = m.Var("x")
        r = m.RDom(0, 10, "prv_r")
        g = m.Func("prv2")
        g[x] = 0
        g[x] += r.x
        g.update().atomic().parallel(r.x)
        return _realize(m, g, [2])
    _check(case, np.array([45, 45], np.int32))


def test_clamped_strided_read():
    """A clamp around a non-unit-stride index (the wavelet/haar pattern)
    replicates the clamp bound's element at the ends, for a positive and a
    negative stride."""
    a = np.arange(10, dtype=np.int32) * 11 + 5

    def case(m, which):
        x = m.Var("x")
        inp = m.ImageParam(m.Int(32), 1, "in1")
        f = m.Func("f")
        if which == "f":
            f[x] = inp[m.clamp(2 * x - 3, 1, 8)]
        else:
            f[x] = inp[m.clamp(7 - 2 * x, 2, 6)]
        inp.set(a)
        return _realize(m, m.Pipeline(f), [8])
    _check(lambda m: case(m, "f"), a[np.clip(2 * np.arange(8) - 3, 1, 8)])
    _check(lambda m: case(m, "g"), a[np.clip(7 - 2 * np.arange(8), 2, 6)])


def test_clamp_span_fully_out_of_range():
    """Every index of the span clamps past one end: each read is the edge
    element."""
    data = np.arange(8, dtype=np.float32)

    def case(m, off):
        x = m.Var("x")
        f = m.Func("cor_f")
        f[x] = m.Buffer(data)[m.clamp(x + off, 0, 7)]
        return _realize(m, f, [6])
    _check(lambda m: case(m, 10), np.full(6, 7.0, np.float32))
    _check(lambda m: case(m, -10), np.zeros(6, np.float32))

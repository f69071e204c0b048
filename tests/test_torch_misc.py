"""The cases of tests/test_correctness_misc.py in both packages:
compute_with (`:10`, `:235`, `:273` with its serializer round trip,
`:321`), the in() wrapper (`:24`), the mirror and repeat boundary
conditions (`:49`), a tuple update (`:64`), realize into a buffer with a
non-zero min (`:89`), specialize variants (`:98`), an extern stage's
bounds query and its double query (`:123`, `:200`), the parallel() RVar
proof (`:153`), the target's features in realize (`:168`, on a CUDA
target's spelling), a clamped strided read (`:178`) and a clamp whose span
lies wholly outside the range (`:333`). Each is built the same way in the
port (realized on the CPU) and in the JAX package, and held against numpy
and against each other, bit for bit."""
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
    its own box), the schedule records it, and the serializer's round trip
    keeps the fused pair and its alignment."""
    def strategy(m):
        las = m.LoopAlignStrategy
        return {"none": None, "start": las.AlignStart, "end": las.AlignEnd,
                "no_align": las.NoAlign,
                "per_dim": {"x": las.AlignStart, "y": las.AlignEnd}}[align]
    recs = {}

    def build(m):
        x, y = m.Var("x"), m.Var("y")
        a, b, c = m.Func("cwa_a"), m.Func("cwa_b"), m.Func("cwa_c")
        a[x, y] = x + y
        b[x, y] = x * y
        a.compute_root()
        b.compute_root()
        a.compute_with(b, x, align=strategy(m))
        c[x, y] = a[x + 1, y] + b[x, y + 1]
        recs[m] = a._defs[0].schedule.fused_with[0]
        return c

    def round_trip(m):
        p2, _imgs, _pars = m.deserialize_pipeline(
            m.serialize_pipeline(m.Pipeline(build(m))))
        a2 = next(f for f in m.pipeline.gather_graph(p2.outputs).funcs
                  if f.name == "cwa_a")
        rec = a2._defs[0].schedule.fused_with[0]
        assert (rec[0][0].name, rec[1], rec[2]) == (
            "cwa_b", "x", recs[m][2])
        return _realize(m, p2, [5, 3])

    xs, ys = np.arange(5), np.arange(3)[:, None]
    _check(lambda m: _realize(m, build(m), [5, 3]),
           (xs + 1 + ys) + xs * (ys + 1))
    for m in (hl, ht):
        s = strategy(m)
        want = (m.LoopAlignStrategy.Auto if s is None
                else s if isinstance(s, m.LoopAlignStrategy) else s["x"])
        assert recs[m][1] == "x" and recs[m][2]["x"] is want
    _check(round_trip, (xs + 1 + ys) + xs * (ys + 1))


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


def test_in_wrapper_redirects():
    def case(m):
        x = m.Var("x")
        f = m.Func("w_f")
        g = m.Func("w_g")
        f[x] = x * 3
        g[x] = f[x] + 1
        w = f.in_(g)
        w.compute_root()
        assert w.name == "w_f_in"
        return _realize(m, g, [5])
    _check(case, np.arange(5, dtype=np.int32) * 3 + 1)


def test_clone_in_wrapper():
    """clone_in redirects only the named consumer: the other keeps reading
    f, and the clone is materialized where it is scheduled."""
    from halide_tpu_torch.pipeline import gather_graph

    def case(m):
        x = m.Var("x")
        f, g, h = m.Func("cw_f"), m.Func("cw_g"), m.Func("cw_h")
        f[x] = x * 3
        g[x] = f[x] + 1
        h[x] = f[x] + g[x]
        cl = f.clone_in(g)
        cl.compute_root()
        if m is ht:
            names = {fn.name for fn in gather_graph([h]).funcs}
            assert names == {"cw_f", "cw_f_clone", "cw_g", "cw_h"}
        return _realize(m, h, [5])
    _check(case, np.arange(5, dtype=np.int32) * 6 + 1)


def test_specialize_accepts_variants():
    def case(m):
        x = m.Var("x")
        p = m.Param(m.Int(32), "sp_p", 1)
        f = m.Func("sp_f")
        f[x] = x + p
        s = f.specialize(p._to_expr() == 1)
        s.vectorize(x, 8)
        p.set(1)
        a = _realize(m, f, [3])
        p.set(5)
        return [a, _realize(m, f, [3])]
    got, ref = _both(case)
    for g, r, w in zip(got, ref, ([1, 2, 3], [5, 6, 7])):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, w)


def test_extern_stage_bounds_query():
    """An extern stage whose footprint needs a +1 halo in x: its callback
    sees the input cropped to that footprint, on the host, and a Func reads
    its output."""
    data = np.arange(48, dtype=np.float32).reshape(6, 8)
    seen = {}

    def case(m):
        bounds = __import__(f"{m.__name__}.bounds", fromlist=["Box"])
        x, y = m.Var("x"), m.Var("y")
        inp = m.ImageParam(m.Float(32), 2, "ext_in")
        inp.set(data)
        seen[m] = boxes = []
        shapes = []

        def footprint(out_box):
            boxes.append([(iv.lo, iv.hi) for iv in out_box.dims])
            return [bounds.Box([bounds.Interval(out_box.dims[0].lo,
                                                out_box.dims[0].hi + 1),
                                out_box.dims[1]])]

        def callback(arr):
            shapes.append((type(arr), arr.shape))
            return (arr[:, :-1] + arr[:, 1:]).astype(np.float32)

        ext = m.Func("ext_stage")
        ext.define_extern("ext_stage", callback, [inp],
                          output_type=m.Float(32), dimensions=2,
                          footprint=footprint)
        out = m.Func("ext_out")
        out[x, y] = ext[x, y] * 2.0
        res = _realize(m, out, [7, 6])
        if m is ht:
            assert shapes == [(np.ndarray, (6, 8))]
        return res
    _check(case, (data[:, :-1] + data[:, 1:]) * 2)
    assert seen[ht] == seen[hl] and seen[ht][0][0] == (0, 6)


def test_extern_double_bounds_query():
    """The stage rounds its output up to a multiple of 4; inputs must be
    sized from the ROUNDED box (reference: BoundsInference.cpp:452-506)."""
    data = np.arange(32, dtype=np.float32)
    seen = {}

    def case(m):
        bounds = __import__(f"{m.__name__}.bounds", fromlist=["Box"])
        x = m.Var("x")
        inp = m.ImageParam(m.Float(32), 1, "dq_in")
        inp.set(data)
        seen[m] = fp_boxes = []

        def bounds_query(out_box):
            lo, hi = out_box.dims[0].lo, out_box.dims[0].hi
            ext4 = -(-(hi - lo + 1) // 4) * 4
            return bounds.Box([bounds.Interval(lo, lo + ext4 - 1)])

        def footprint(out_box):
            fp_boxes.append((out_box.dims[0].lo, out_box.dims[0].hi))
            return [bounds.Box([out_box.dims[0]])]

        ext = m.Func("dq_stage")
        ext.define_extern("dq_stage", lambda a: (a * 3.0).astype(np.float32),
                          [inp], output_type=m.Float(32), dimensions=1,
                          footprint=footprint, bounds_query=bounds_query)
        out = m.Func("dq_out")
        out[x] = ext[x] + 1.0
        return _realize(m, out, [7])      # 7 -> the stage produces 8
    _check(case, data[:7] * 3 + 1)
    assert seen[ht] == seen[hl] and seen[ht][0] == (0, 7)


def test_extern_stage_feeds_a_group():
    """An extern stage's output is a window of a tiled group: the group
    kernel's plan takes it, and the result is the stencil of the callback's
    values."""
    from halide_tpu_torch.ops import group_kernel as gk
    data = np.arange(20 * 24, dtype=np.float32).reshape(20, 24)
    x, y = ht.Var("x"), ht.Var("y")
    xo, yo, xi, yi = (ht.Var(n) for n in ("xo", "yo", "xi", "yi"))
    inp = ht.ImageParam(ht.Float(32), 2, "eg_in")
    inp.set(data)
    ext = ht.Func("eg_stage")
    ext.define_extern("eg_stage", lambda a: a * 0.5, [inp],
                      output_type=ht.Float(32), dimensions=2)
    bx, by = ht.Func("eg_bx"), ht.Func("eg_by")
    bx[x, y] = ext[x, y] + ext[x + 1, y]
    by[x, y] = bx[x, y] + bx[x, y + 1]
    by.tile(x, y, xo, yo, xi, yi, 8, 4)
    bx.compute_at(by, xo)
    gk.last_plan = None
    out = by.realize([20, 16], device="cpu").to_numpy()
    e = data * 0.5
    b = e[:, :-1] + e[:, 1:]
    np.testing.assert_array_equal(out, (b[:-1] + b[1:])[:16, :20])
    assert gk.last_plan["windows"] == ["eg_stage"]


def test_target_features_wire_into_realize():
    outs = []
    for m, spec in ((hl, "cpu-generic-no_pallas"),
                    (ht, "cuda-sm_90-no_pallas")):
        x = m.Var("x")
        f = m.Func("tgt_f")
        f[x] = x * 2
        outs.append(_np(_realize(m, f, [4], target=spec)))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[1], [0, 2, 4, 6])
    t = hl.Target("tpu-v5e-profile-trace_all")
    assert t.has_feature("profile") and t.generation == "v5e"
    t = ht.Target("cuda-sm_90-profile-trace_all-interpret-strict_float")
    assert t.has_feature("profile") and t.generation == "sm_90"
    assert t.features == {"profile", "trace_all", "interpret",
                          "strict_float"}
    with pytest.raises(ValueError, match="TPU feature"):
        ht.Target("cuda-sm_90-megacore")


def test_compile_to_callable_and_infer_input_bounds():
    """compile_to_callable binds its arguments in order and realizes;
    infer_input_bounds binds zero-filled buffers over the required
    regions (here x in [0, 9] and y in [-1, 8]), in both packages."""
    res = {}
    for m in (hl, ht):
        x, y = m.Var("x"), m.Var("y")
        inp = m.ImageParam(m.Int(32), 2, "cc_in")
        k = m.Param(m.Int(32), "cc_k", 0)
        f = m.Func("cc_f")
        f[x, y] = inp[x + 1, y] + inp[x, y + 1] * k
        fn = m.Pipeline(f).compile_to_callable([inp, k])
        a = np.arange(60, dtype=np.int32).reshape(6, 10)
        kw = {"device": "cpu"} if m is ht else {}
        out = _np(fn(a, 3, sizes=[9, 5], **kw))
        g = m.Func("cc_g")
        ib = m.ImageParam(m.Int(32), 2, "cc_ib")
        g[x, y] = ib[x + 1, y] + ib[x, y - 1]
        bufs = m.Pipeline(g).infer_input_bounds([9, 9], **kw)
        res[m] = (out, [(list(b._mins), _np(b).shape) for b in bufs],
                  _np(g.realize([9, 9], **kw)))
    assert res[ht][1] == res[hl][1] == [([0, -1], (10, 10))]
    for a, b in zip(res[ht][::2], res[hl][::2]):
        np.testing.assert_array_equal(a, b)
    a = np.arange(60, dtype=np.int32).reshape(6, 10)
    np.testing.assert_array_equal(res[ht][0], a[0:5, 1:10] + a[1:6, 0:9] * 3)
    assert not res[ht][2].any()


def test_get_func_and_print_loop_nest():
    import contextlib
    import io
    from halide_tpu.loopnest import loop_nest_str as jax_nest
    texts = []
    for m in (hl, ht):
        x = m.Var("x")
        f, g = m.Func("gf_f"), m.Func("gf_g")
        f[x] = x
        g[x] = f[x] * 2
        f.compute_root()
        p = m.Pipeline(g)
        assert [p.get_func(i).name for i in (0, 1)] == ["gf_f", "gf_g"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            p.print_loop_nest()
            g.print_loop_nest()
        texts.append(buf.getvalue())
        if m is hl:
            assert texts[0] == (jax_nest(g) + "\n") * 2
    assert texts[0] == texts[1]

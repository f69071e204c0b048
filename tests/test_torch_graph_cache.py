"""`Pipeline._prepare` reuses its last graph walk while no definition has
changed (halide_tpu_torch/func.py's definition epoch, pipeline.py's
`Pipeline._graph`), on the CPU: a second realize does not walk; a realize
after each definition mutator walks again and gives a fresh Pipeline's
output; a schedule change, a new Param value and a rebound ImageParam
re-key the plan without a walk; a Func used before it is defined raises on
every realize; and the benchmark's reader `graph_cache.hit_share` on a
small cell's window."""
import sys
import time

import numpy as np
import pytest
import torch

import halide_tpu_torch as ht
from halide_tpu_torch import func as fn_mod
from halide_tpu_torch import pipeline as pl
from halide_tpu_torch import spans

N = 16


def _buf(seed, n=N):
    return ht.Buffer(np.random.default_rng(seed).random(n, dtype=np.float32))


def _counts():
    c = spans.counters()
    return {k: c[k] for k in ("graph_cache.hits", "graph_cache.misses",
                              "plan_cache.hits", "plan_cache.misses")}


def _moved(c0):
    return {k: v - c0[k] for k, v in _counts().items()}


def _realize(p, n=N):
    return p.realize([n], device="cpu").to_numpy()


def _walk_is_fresh(p):
    """The walk `p` keeps is the walk gather_graph makes now."""
    g = pl.gather_graph(p.outputs)
    _epoch, funcs, inputs, params = p._walk
    assert [id(f) for f in funcs] == [id(f) for f in g.funcs]
    assert list(inputs) == list(g.inputs)
    assert list(params) == list(g.params)


def test_a_second_realize_does_not_walk(monkeypatch):
    x = ht.Var("x")
    inp = ht.ImageParam(ht.Float(32), 1, "gc_in")
    inp.set(_buf(0))
    f, out = ht.Func("gc_f"), ht.Func("gc_out")
    f[x] = inp[x] * 2.0
    out[x] = f[x] + 1.0
    p = ht.Pipeline(out)
    first = _realize(p)
    walks = []
    real = pl.gather_graph
    monkeypatch.setattr(pl, "gather_graph",
                        lambda outs: walks.append(1) or real(outs))
    c0 = _counts()
    second = _realize(p)
    assert walks == []
    assert _moved(c0) == {"graph_cache.hits": 1, "graph_cache.misses": 0,
                          "plan_cache.hits": 1, "plan_cache.misses": 0}
    np.testing.assert_array_equal(first, second)
    rec = spans.recent()[-1]["spans"]
    assert rec["ht.graph_reuse"]["count"] == 1
    assert rec["ht.gather_graph"]["count"] == 1


# ---------------------------------------------------------------------------
# each definition mutator: a case builds outputs, realizes them, mutates,
# and realizes again; each mutation brings a Func, an input or a Param the
# kept walk does not hold
# ---------------------------------------------------------------------------

def _pure_redefinition():
    x = ht.Var("x")
    inp, other = _buf(1), _buf(2)
    f = ht.Func("gm_pure")
    f[x] = inp[x] * 2.0

    def mutate():
        f[x] = other[x] + 1.0           # a pure-form definition again
    return [f], mutate


def _added_update():
    x = ht.Var("x")
    inp = _buf(3)
    q = ht.Param(ht.Float(32), "gm_q", 0.5)
    out, extra = ht.Func("gm_upd"), ht.Func("gm_extra")
    out[x] = inp[x]

    def mutate():
        extra[x] = inp[x] * q
        out[x] = out[x] + extra[x]
    return [out], mutate


def _define_extern():
    x = ht.Var("x")
    inp = _buf(4)
    base, other = ht.Func("gm_base"), ht.Func("gm_ext")
    base[x] = inp[x] * 3.0
    base.compute_root()             # an extern stage reads buffers
    out = ht.Func("gm_outer")
    out.define_extern("gm_outer", lambda a, b: a + b, [base, other],
                      ht.Float(32), 1)

    def mutate():
        other.define_extern("gm_ext", lambda a: a * 0.25, [_buf(5)],
                            ht.Float(32), 1)
    return [out], mutate


def _func_in():
    x = ht.Var("x")
    inp = _buf(6)
    f, out = ht.Func("gm_f"), ht.Func("gm_cons")
    f[x] = inp[x] * 2.0
    out[x] = f[x] + f[x] * f[x]

    def mutate():
        w = f.in_(out)
        w.compute_root()
    return [out], mutate


def _rfactor():
    x, u = ht.Var("x"), ht.Var("u")
    inp = _buf(7, 64)
    r = ht.RDom(0, 64)
    out = ht.Func("gm_total")
    out[x] = 0.0
    out[x] += inp[r.x] + ht.cast(ht.Float(32), x)

    def mutate():
        ro, ri = ht.RVar("ro"), ht.RVar("ri")
        out.update().split(r.x, ro, ri, 8)
        out.update().rfactor(ro, u)
    return [out], mutate


def _specialize():
    x = ht.Var("x")
    inp = _buf(8)
    q = ht.Param(ht.Int(32), "gm_sel", 3)
    f, out = ht.Func("gm_sp"), ht.Func("gm_spo")
    f[x] = inp[x] * 2.0
    out[x] = f[x] + 1.0

    def mutate():
        f.specialize(q._to_expr() > 1)
    return [out], mutate


def _rdom_where():
    x = ht.Var("x")
    inp = _buf(9, N + 4)
    q = ht.Param(ht.Int(32), "gm_lim", 2)
    r = ht.RDom(0, 4, "gm_r")
    out = ht.Func("gm_where")
    out[x] = ht.sum(inp[x + r.x])

    def mutate():
        r.where(r.x < q._to_expr())
    return [out], mutate


def _rvar_bounds():
    x = ht.Var("x")
    inp = _buf(10, N + 4)
    q = ht.Param(ht.Int(32), "gm_ext_q", 3)
    r = ht.RDom(0, 4, "gm_rb")
    out = ht.Func("gm_bounds")
    out[x] = ht.sum(inp[x + r.x])

    def mutate():
        r.x.rextent = q._to_expr()
    return [out], mutate


def _definition_fields():
    x = ht.Var("x")
    inp, other = _buf(11), _buf(12)
    out = ht.Func("gm_fields")
    out[x] = inp[x] + 1.0

    def mutate():
        out._defs[0].values = (other[x] * 4.0,)
    return [out], mutate


MUTATORS = {"pure_redefinition": _pure_redefinition,
            "added_update": _added_update,
            "define_extern": _define_extern,
            "func_in": _func_in,
            "rfactor": _rfactor,
            "specialize": _specialize,
            "rdom_where": _rdom_where,
            "rvar_bounds": _rvar_bounds,
            "definition_fields": _definition_fields}
# mutators that keep the output's values: only the walk shows the change
SAME_VALUES = {"define_extern", "func_in", "specialize"}


@pytest.mark.parametrize("name", sorted(MUTATORS))
def test_a_realize_after_a_definition_changes_walks_again(name):
    outputs, mutate = MUTATORS[name]()
    p = ht.Pipeline(outputs)
    n = 1 if name == "rfactor" else N
    if name == "define_extern":
        # an extern stage reads a Func not yet defined: the walk raises
        # and keeps nothing, until the mutator defines it
        with pytest.raises(ht.CompileError, match="before it is defined"):
            _realize(p, n)
        assert p._walk is None
    else:
        before = _realize(p, n)
        _realize(p, n)
        assert p._walk is not None
    epoch = fn_mod.definition_epoch()
    mutate()
    assert fn_mod.definition_epoch() > epoch
    c0 = _counts()
    after = _realize(p, n)
    moved = _moved(c0)
    assert moved["graph_cache.misses"] == 1 and moved["graph_cache.hits"] == 0
    _walk_is_fresh(p)
    np.testing.assert_array_equal(after, _realize(ht.Pipeline(outputs), n))
    if name not in SAME_VALUES:
        assert not np.array_equal(after, before)
    # and the walk made after the change is reused
    c0 = _counts()
    np.testing.assert_array_equal(_realize(p, n), after)
    assert _moved(c0)["graph_cache.hits"] == 1


def test_deserializing_defines_and_bumps_the_epoch():
    x = ht.Var("x")
    inp = ht.ImageParam(ht.Float(32), 1, "gm_ser_in")
    inp.set(_buf(13))
    f = ht.Func("gm_ser")
    f[x] = inp[x] * 2.0
    text = ht.serialize_pipeline(ht.Pipeline(f))
    epoch = fn_mod.definition_epoch()
    p, imgs, _params = ht.deserialize_pipeline(text)
    assert fn_mod.definition_epoch() > epoch
    imgs["gm_ser_in"].set(_buf(13))
    np.testing.assert_array_equal(_realize(p), _realize(ht.Pipeline(f)))


def test_schedules_and_plan_copies_of_definitions_leave_the_epoch():
    """Schedule directives are not definitions, and the copies of a
    Definition that evaluation makes (K1's plain version) are held by no
    Func: neither bumps the epoch."""
    x, xo, xi = ht.Var("x"), ht.Var("xo"), ht.Var("xi")
    f = ht.Func("gm_sched")
    f[x] = _buf(14)[x] * 2.0
    epoch = fn_mod.definition_epoch()
    f.compute_root()
    f.split(x, xo, xi, 4)
    f.vectorize(xi)
    d = f._defs[0]
    d2 = d.replaced(values=(d.values[0] + 1.0,))
    assert fn_mod.definition_epoch() == epoch
    assert d2.values[0] is not d.values[0] and f._defs[0] is d


def test_a_schedule_change_rematerializes_and_replans_without_a_walk():
    x = ht.Var("x")
    inp = ht.ImageParam(ht.Float(32), 1, "gs_in")
    inp.set(_buf(15, N + 1))
    f, out = ht.Func("gs_f"), ht.Func("gs_out")
    f[x] = inp[x] * 2.0
    out[x] = f[x] + f[x + 1]
    p = ht.Pipeline(out)
    want = _realize(p)
    assert id(f) not in p._graph().materialized
    for root in (True, False):
        if root:
            f.compute_root()
        else:
            f.compute_inline()
        c0 = _counts()
        np.testing.assert_allclose(_realize(p), want, rtol=1e-6)
        moved = _moved(c0)
        assert moved["graph_cache.misses"] == 0
        assert moved["graph_cache.hits"] == 1
        assert moved["plan_cache.misses"] == 1     # the key holds schedules
        assert (id(f) in p._graph().materialized) == root


def test_an_inlined_func_with_updates_raises_on_every_realize():
    x = ht.Var("x")
    f, out = ht.Func("gi_f"), ht.Func("gi_out")
    f[x] = _buf(16)[x]
    f[x] = f[x] * 2.0
    out[x] = f[x] + 1.0
    p = ht.Pipeline(out)
    _realize(p)
    f.compute_inline()
    for _ in range(2):
        with pytest.raises(ht.CompileError, match="cannot be inlined"):
            _realize(p)
    assert p._walk is not None          # the walk stands; the schedule raised


def test_a_func_used_before_it_is_defined_raises_on_every_realize():
    x = ht.Var("x")
    g, ext = ht.Func("gu_g"), ht.Func("gu_ext")
    ext.define_extern("gu_ext", lambda a: a + 1.0, [g], ht.Float(32), 1)
    p = ht.Pipeline(ext)
    c0 = _counts()
    for _ in range(3):
        with pytest.raises(ht.CompileError, match="gu_g is used before"):
            _realize(p)
        assert p._walk is None
    assert _moved(c0)["graph_cache.misses"] == 3
    g[x] = _buf(17)[x]
    g.compute_root()                    # an extern stage reads buffers
    np.testing.assert_allclose(_realize(p), _buf(17).to_numpy() + 1.0)


def test_a_new_param_value_rekeys_the_plan_without_a_walk():
    x = ht.Var("x")
    inp = ht.ImageParam(ht.Float(32), 1, "gp_in")
    inp.set(_buf(18))
    q = ht.Param(ht.Float(32), "gp_q", 2.0)
    out = ht.Func("gp_out")
    out[x] = inp[x] * q
    p = ht.Pipeline(out)
    _realize(p)
    q.set(3.0)
    c0 = _counts()
    np.testing.assert_allclose(_realize(p), _buf(18).to_numpy() * 3.0,
                               rtol=1e-6)
    assert _moved(c0) == {"graph_cache.hits": 1, "graph_cache.misses": 0,
                          "plan_cache.hits": 0, "plan_cache.misses": 1}


@pytest.mark.parametrize("n", [N, N + 8])
def test_a_rebound_image_param_rekeys_the_plan_without_a_walk(n):
    x = ht.Var("x")
    inp = ht.ImageParam(ht.Float(32), 1, "gb_in")
    inp.set(_buf(19))
    out = ht.Func("gb_out")
    out[x] = inp[x] + 1.0
    p = ht.Pipeline(out)
    _realize(p)
    inp.set(_buf(20, n))
    c0 = _counts()
    np.testing.assert_allclose(_realize(p, n), _buf(20, n).to_numpy() + 1.0)
    # the same shape finds its plan, another shape plans anew
    assert _moved(c0) == {"graph_cache.hits": 1, "graph_cache.misses": 0,
                          "plan_cache.hits": int(n == N),
                          "plan_cache.misses": int(n != N)}


# ---------------------------------------------------------------------------
# the benchmark's reader
# ---------------------------------------------------------------------------

def _reader():
    from bench_h100.spec import HERE, load_module
    return load_module(HERE / "metrics" / "graph_cache.hit_share.py")


def test_hit_share_reads_100_on_a_small_cells_window(monkeypatch):
    from bench_h100 import frames, run
    from bench_h100.spec import HERE, find_cell, load_json
    torch.set_num_threads(1)
    monkeypatch.setattr(frames, "RING_MIN_BYTES", 100_000)
    benchmark = load_json(HERE.parent / "BENCHMARK.json")
    cell = find_cell(benchmark, "camera_pipe.frames")
    cell.size = [256, 128]
    cell.config["args"]["tile"] = [256, 64]
    assert "graph_cache.hit_share" in cell.metrics
    units = {m["name"]: m["unit"]
             for m in benchmark["end_to_end"] + benchmark["per_layer"]}
    res = run.run_cell(cell, 2 ** 31 + 5, 0.3, True, "cpu",
                       time.perf_counter(), units)["result"]
    assert res["correct"] is True
    assert res["metrics"]["graph_cache.hit_share"] == {"value": 100.0,
                                                       "unit": "%"}


def _ring(reused):
    """Frame marks at 10, 11 and 12 s, and the ring's records of the
    realizes inside them, `reused` saying which reused their walk."""
    from bench_h100.frames import Span
    marks = [Span(t, t + 0.001, t + 0.101, t + 0.102) for t in (10, 11, 12)]
    ring = [{"seq": k, "start_ns": int((s.call + 1e-4) * 1e9),
             "end_ns": int((s.ret - 1e-4) * 1e9), "hit": True,
             "spans": {kind: {"count": int(kind == "ht.graph_reuse" and r),
                              "total_ns": 0, "self_ns": 0}
                       for kind in spans.KINDS}}
            for k, (s, r) in enumerate(zip(marks, reused))]
    return marks, ring


@pytest.mark.parametrize("reused,want", [((True, True, True), 100.0),
                                         ((False, True, True), 200 / 3),
                                         ((False, False, False), 0.0)])
def test_hit_share_is_the_windows_realizes_that_reused_the_walk(
        reused, want, monkeypatch):
    marks, ring = _ring(reused)
    monkeypatch.setattr(spans, "recent", lambda: ring)
    assert _reader().read({"spans": marks}) == pytest.approx(want)
    assert _reader().read({"spans": []}) is None


def test_hit_share_reads_nothing_on_a_port_without_the_span(monkeypatch):
    """The parent's port has spans but no `ht.graph_reuse` kind, or no
    spans at all: the reader gives None there, and raises nothing."""
    import halide_tpu_torch
    marks, ring = _ring((True,) * 3)
    monkeypatch.setattr(spans, "recent", lambda: ring)
    monkeypatch.setattr(spans, "KINDS", tuple(
        k for k in spans.KINDS if k != "ht.graph_reuse"))
    assert _reader().read({"spans": marks}) is None
    monkeypatch.setitem(sys.modules, "halide_tpu_torch.spans", None)
    monkeypatch.delattr(halide_tpu_torch, "spans")
    assert _reader().read({"spans": marks}) is None

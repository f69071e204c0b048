"""The port's realize spans and counters (halide_tpu_torch/spans.py) on the
CPU: one ring record a realize, its kinds nested and their self times, the
plan cache's first realize apart from its hits, the profiler ranges as host
events of function scope, and the ring keeping its newest records."""
import numpy as np
import pytest
import torch

import halide_tpu_torch as ht
from halide_tpu_torch import pipeline as pl
from halide_tpu_torch import spans

# each kind's parent
PARENT = {"ht.prepare": "ht.realize", "ht.gather_graph": "ht.prepare",
          "ht.plan_key": "ht.prepare", "ht.plan_build": "ht.prepare",
          "ht.run": "ht.realize", "ht.bounds": "ht.run",
          "ht.stage": "ht.run", "ht.k1": "ht.run",
          "ht.k1.plan": "ht.k1", "ht.k1.launch": "ht.k1",
          "ht.replay": "ht.run", "ht.contract": "ht.stage",
          "ht.graph_reuse": "ht.gather_graph", "ht.scan": "ht.stage"}
FIRST_ONLY = ("ht.plan_build", "ht.bounds", "ht.k1.plan")


def _stage_and_group(w=96, h=64, tile=(32, 16)):
    """One whole-array stage (`pre`, stored at root) read by one K1 group
    (`by` tiled, `bx` computed at its tiles); -> (pipeline, sizes)."""
    x, y = ht.Var("x"), ht.Var("y")
    xo, yo, xi, yi = ht.Var("xo"), ht.Var("yo"), ht.Var("xi"), ht.Var("yi")
    inp = ht.ImageParam(ht.UInt(16), 2, "sp_in")
    pre, bx, by = ht.Func("sp_pre"), ht.Func("sp_bx"), ht.Func("sp_by")
    pre[x, y] = inp[x, y] * 2 + 1
    bx[x, y] = (pre[x, y] + pre[x + 1, y] + pre[x + 2, y]) / 3
    by[x, y] = (bx[x, y] + bx[x, y + 1] + bx[x, y + 2]) / 3
    pre.compute_root()
    by.tile(x, y, xo, yo, xi, yi, tile[0], tile[1])
    bx.compute_at(by, xo)
    rng = np.random.default_rng(5)
    inp.set(ht.Buffer(rng.integers(0, 1 << 12, size=(h, w),
                                   dtype=np.uint16)))
    return ht.Pipeline(by), [w - 2, h - 2]


def _realizes(p, sizes, n):
    """n realizes on the CPU -> their ring records."""
    before = spans._ring.written
    for _ in range(n):
        p.realize(sizes, device="cpu")
    assert spans._ring.written == before + n
    return spans.recent()[-n:]


def test_a_realize_writes_one_record():
    p, sizes = _stage_and_group()
    before = spans._ring.written
    out = p.realize(sizes, device="cpu")
    assert spans._ring.written == before + 1
    (rec,) = spans.recent()[-1:]
    assert rec["seq"] == before
    assert rec["start_ns"] < rec["end_ns"]
    assert rec["spans"]["ht.realize"]["count"] == 1
    assert rec["spans"]["ht.realize"]["total_ns"] == \
        rec["end_ns"] - rec["start_ns"]
    assert out.to_numpy().shape == (sizes[1], sizes[0])


def test_children_fit_their_parents_and_self_times_are_not_negative():
    p, sizes = _stage_and_group()
    for rec in _realizes(p, sizes, 2):
        s = rec["spans"]
        for kind, parent in PARENT.items():
            assert s[kind]["total_ns"] <= s[parent]["total_ns"], kind
        for parent in set(PARENT.values()):
            kids = sum(s[k]["total_ns"] for k, q in PARENT.items()
                       if q == parent)
            assert kids <= s[parent]["total_ns"], parent
            assert s[parent]["self_ns"] == s[parent]["total_ns"] - kids
        for kind in spans.KINDS:
            assert 0 <= s[kind]["self_ns"] <= s[kind]["total_ns"], kind
        # the self times partition the realize
        assert sum(v["self_ns"] for v in s.values()) == \
            s["ht.realize"]["total_ns"]


def test_one_stage_span_a_stage_and_one_k1_span_a_realize():
    p, sizes = _stage_and_group()
    for rec in _realizes(p, sizes, 3):
        s = rec["spans"]
        assert s["ht.stage"]["count"] == 1          # sp_pre
        assert s["ht.k1"]["count"] == 1             # sp_by with sp_bx
        assert s["ht.k1.launch"]["count"] == 0      # the plain version
        for kind in ("ht.realize", "ht.prepare", "ht.gather_graph",
                     "ht.plan_key", "ht.run"):
            assert s[kind]["count"] == 1, kind


def test_first_realize_misses_the_plan_cache_and_the_rest_hit():
    p, sizes = _stage_and_group()
    c0 = spans.counters()
    first, *rest = _realizes(p, sizes, 4)
    c1 = spans.counters()
    assert c1["plan_cache.misses"] - c0["plan_cache.misses"] == 1
    assert c1["plan_cache.hits"] - c0["plan_cache.hits"] == 3
    assert pl.plan_cache == {"hits": c1["plan_cache.hits"],
                             "misses": c1["plan_cache.misses"]}
    assert not first["hit"] and all(r["hit"] for r in rest)
    for kind in FIRST_ONLY:
        assert first["spans"][kind]["count"] == 1, kind
        assert all(r["spans"][kind]["count"] == 0 for r in rest), kind


def test_the_graph_walk_is_reused_after_the_first_realize():
    """The first realize walks the graph; the rest reuse the walk, each
    marking an `ht.graph_reuse` span inside its `ht.gather_graph`."""
    p, sizes = _stage_and_group()
    c0 = spans.counters()
    first, *rest = _realizes(p, sizes, 3)
    c1 = spans.counters()
    assert c1["graph_cache.misses"] - c0["graph_cache.misses"] == 1
    assert c1["graph_cache.hits"] - c0["graph_cache.hits"] == 2
    assert pl.graph_cache == {"hits": c1["graph_cache.hits"],
                              "misses": c1["graph_cache.misses"]}
    assert first["spans"]["ht.graph_reuse"]["count"] == 0
    for r in rest:
        assert r["spans"]["ht.graph_reuse"]["count"] == 1
        assert r["spans"]["ht.gather_graph"]["count"] == 1


def test_counters_read_the_port_where_it_counts():
    from halide_tpu_torch.ops import (build, group_kernel, rowhist_kernel,
                                      scan_kernel, stage_kernel)
    c = spans.counters()
    assert c["kernels.built"] == len(build.builds)
    assert c["kernels.loaded"] == len(build._LIBS)
    assert c["group_kernel.launches"] == group_kernel.launches
    assert c["scan_kernel.launches"] == sum(scan_kernel.launches.values())
    assert c["rowhist_kernel.launches"] == rowhist_kernel.launches
    assert c["stage_kernel.fused"] == stage_kernel.fused
    assert c["stage_kernel.declined"] == stage_kernel.declined


def test_totals_add_every_record():
    p, sizes = _stage_and_group()
    t0 = spans.totals()
    recs = _realizes(p, sizes, 2)
    t1 = spans.totals()
    for kind in spans.KINDS:
        for field in ("count", "total_ns", "self_ns"):
            assert t1[kind][field] - t0[kind][field] == \
                sum(r["spans"][kind][field] for r in recs), (kind, field)


def test_profiler_ranges_are_host_events_inside_the_realize():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    p, sizes = _stage_and_group()
    p.realize(sizes, device="cpu")
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        p.realize(sizes, device="cpu")
    evs = [e for e in prof.events() if e.name.startswith("ht.")]
    names = [e.name for e in evs]
    assert names.count("ht.realize") == 1
    assert {"ht.prepare", "ht.gather_graph", "ht.plan_key", "ht.run",
            "ht.stage", "ht.k1"} <= set(names)
    (root,) = [e for e in evs if e.name == "ht.realize"]
    for e in evs:
        assert e.device_type == DeviceType.CPU
        assert int(e.scope) != 7                  # not USER_SCOPE
        assert root.time_range.start <= e.time_range.start
        assert e.time_range.end <= root.time_range.end
    (stage,) = [e for e in evs if e.name == "ht.stage"]
    (k1,) = [e for e in evs if e.name == "ht.k1"]
    assert stage.kwinputs == {"func": "sp_pre"}
    assert k1.kwinputs == {"func": "sp_by"}


def test_no_profiler_range_is_made_without_a_session(monkeypatch):
    made = []

    def spy(*args):
        made.append(args)
        return torch._C._profiler._RecordFunctionFast(*args)
    monkeypatch.setattr(spans, "_Range", spy)
    p, sizes = _stage_and_group()
    _realizes(p, sizes, 2)
    assert made == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        _realizes(p, sizes, 1)
    assert len(made) >= 6


def test_a_span_outside_a_realize_records_nothing():
    before = (spans._ring.written, spans.totals())
    with spans.span(spans.STAGE, "alone"):
        pass
    assert (spans._ring.written, spans.totals()) == before


def test_the_ring_keeps_the_newest_records(monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 3)
    monkeypatch.setattr(spans, "_ring", spans._Ring())
    p, sizes = _stage_and_group()
    recs = _realizes(p, sizes, 5)
    assert [r["seq"] for r in spans.recent()] == [2, 3, 4]
    assert spans.totals()["ht.realize"]["count"] == 5
    assert recs[-1] == spans.recent()[-1]


def test_within_selects_the_realizes_inside_each_interval():
    p, sizes = _stage_and_group()
    recs = _realizes(p, sizes, 3)
    iv = [(r["start_ns"], r["end_ns"]) for r in recs]
    assert spans.within(iv) == recs
    assert spans.within(iv[1:2]) == recs[1:2]
    assert spans.within([(recs[0]["start_ns"], recs[2]["end_ns"])]) == recs
    # an interval the ring holds no realize in
    assert spans.within(iv + [(recs[2]["end_ns"] + 1,
                               recs[2]["end_ns"] + 2)]) is None


def test_a_failed_realize_still_closes_its_record():
    x = ht.Var("x")
    inp = ht.ImageParam(ht.Float(32), 1, "sp_unbound")
    f = ht.Func("sp_f")
    f[x] = inp[x] + 1
    before = spans._ring.written
    with pytest.raises(ht.CompileError):
        ht.Pipeline(f).realize([8], device="cpu")
    assert spans._ring.written == before + 1
    assert not spans._stack

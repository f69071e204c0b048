"""The readers of the port's realize spans, on a synthetic traced run: the
window's frame marks, the port's ring of realize records and a profile with
host ranges and launch events."""
import sys

import pytest

from bench_h100.frames import Span
from bench_h100.profile import Profile
from bench_h100.spec import HERE, load_module
from halide_tpu_torch import spans

HOST_MS = ("prepare.host_ms", "eval_torch.host_ms", "k1.host_ms")
NEW = HOST_MS + ("plan.build_ms", "eval_torch.launches")


def _read(name, rec):
    return load_module(HERE / "metrics" / f"{name}.py").read(rec)


def _record(seq, start_s, end_s, ms):
    """A ring record of a realize from start_s to end_s (perf_counter
    seconds) with `ms` {kind: total ms}."""
    return {"seq": seq, "start_ns": int(start_s * 1e9),
            "end_ns": int(end_s * 1e9), "hit": seq > 0,
            "spans": {k: {"count": int(k in ms), "total_ns": int(
                ms.get(k, 0) * 1e6), "self_ns": 0} for k in spans.KINDS}}


def _window():
    """Three frames at 10, 11 and 12 s; the ring holds the planning realize
    before them, their realizes and a profiled frame's after them."""
    marks = [Span(t, t + 0.001, t + 0.101, t + 0.102) for t in (10, 11, 12)]
    ms = [{"ht.prepare": 20, "ht.stage": 60, "ht.k1": 1},
          {"ht.prepare": 22, "ht.stage": 64, "ht.k1": 2},
          {"ht.prepare": 24, "ht.stage": 68, "ht.k1": 3}]
    ring = [_record(0, 5.0, 6.5, {"ht.prepare": 900, "ht.stage": 300,
                                  "ht.k1": 200})]
    ring += [_record(k + 1, s.call + 0.0001, s.ret - 0.0001, m)
             for k, (s, m) in enumerate(zip(marks, ms))]
    ring.append(_record(4, 13.0, 13.1, {"ht.prepare": 99, "ht.stage": 99,
                                        "ht.k1": 99}))
    return marks, ring


@pytest.mark.parametrize("name,want", [("prepare.host_ms", 22.0),
                                       ("eval_torch.host_ms", 64.0),
                                       ("k1.host_ms", 2.0)])
def test_host_ms_is_the_mean_over_the_windows_realizes(name, want,
                                                       monkeypatch):
    marks, ring = _window()
    monkeypatch.setattr(spans, "recent", lambda: ring)
    assert _read(name, {"spans": marks}) == pytest.approx(want)


@pytest.mark.parametrize("name", HOST_MS)
def test_host_ms_is_none_where_the_ring_lost_a_frame(name, monkeypatch):
    marks, ring = _window()
    monkeypatch.setattr(spans, "recent", lambda: ring[:1] + ring[2:])
    assert _read(name, {"spans": marks}) is None
    # a ring that wrapped past the window's first frame
    monkeypatch.setattr(spans, "recent", lambda: ring[2:])
    assert _read(name, {"spans": marks}) is None
    assert _read(name, {"spans": []}) is None


def test_plan_build_ms_is_the_planning_spans_over_the_misses(monkeypatch):
    tot = {k: {"count": 1, "total_ns": 0, "self_ns": 0} for k in spans.KINDS}
    tot["ht.plan_build"]["total_ns"] = 1_000_000
    tot["ht.bounds"]["total_ns"] = 30_000_000
    tot["ht.k1.plan"]["total_ns"] = 50_000_000
    tot["ht.stage"]["total_ns"] = 999_000_000       # not planning
    monkeypatch.setattr(spans, "totals", lambda: tot)
    monkeypatch.setattr(spans, "counters",
                        lambda: {"plan_cache.misses": 2})
    assert _read("plan.build_ms", {}) == pytest.approx(40.5)
    monkeypatch.setattr(spans, "counters",
                        lambda: {"plan_cache.misses": 0})
    assert _read("plan.build_ms", {}) is None


def _profile(host):
    return Profile(2, 2000.0, [("group_abc", 0, 100)], host, 1, 1)


def test_eval_torch_launches_counts_only_launches_inside_a_stage():
    host = [("bench.frame", 0, 990), ("ht.realize", 1, 980),
            ("ht.stage", 10, 100), ("cudaLaunchKernel", 20, 22),
            ("cudaLaunchKernel", 50, 51), ("aten::add", 60, 70),
            ("cudaLaunchKernel", 99, 101),     # starts inside, ends after
            ("ht.k1", 200, 300), ("cudaLaunchKernel", 250, 251),
            ("cudaMemcpyAsync", 400, 402),
            ("bench.frame", 995, 2000), ("ht.realize", 996, 1990),
            ("ht.stage", 1000, 1100), ("cuLaunchKernel", 1000, 1002),
            ("cudaLaunchKernel", 1100, 1101),  # at the stage's end: outside
            ("cudaLaunchKernel", 1500, 1501)]
    assert _read("eval_torch.launches", {"profile": _profile(host)}) == \
        pytest.approx(4 / 2)


def test_eval_torch_launches_is_none_without_stage_ranges():
    host = [("bench.frame", 0, 990), ("cudaLaunchKernel", 20, 22)]
    assert _read("eval_torch.launches", {"profile": _profile(host)}) is None
    assert _read("eval_torch.launches", {"profile": None}) is None


@pytest.mark.parametrize("name", NEW)
def test_a_port_without_spans_reads_nothing(name, monkeypatch):
    """The parent's port has no `spans` module: every new reader gives
    None there, and raises nothing."""
    import halide_tpu_torch
    marks, _ring = _window()
    monkeypatch.setitem(sys.modules, "halide_tpu_torch.spans", None)
    monkeypatch.delattr(halide_tpu_torch, "spans")
    host = [("bench.frame", 0, 990), ("cudaLaunchKernel", 20, 22)]
    assert _read(name, {"spans": marks, "profile": _profile(host)}) is None

"""The reader of `plan_graph.replay_share` on a synthetic traced run: the
window's frame marks and the port's ring of realize records, some of them
replays of the plan's CUDA graph."""
import sys

import pytest

from bench_h100.frames import Span
from bench_h100.spec import HERE, load_module
from halide_tpu_torch import spans

NAME = "plan_graph.replay_share"


def _read(rec):
    return load_module(HERE / "metrics" / f"{NAME}.py").read(rec)


def _record(seq, start_s, end_s, replayed):
    return {"seq": seq, "start_ns": int(start_s * 1e9),
            "end_ns": int(end_s * 1e9), "hit": seq > 0,
            "spans": {k: {"count": int(k == "ht.replay" and replayed),
                          "total_ns": 0, "self_ns": 0}
                      for k in spans.KINDS}}


def _window(replayed):
    """Frames at 10, 11, 12 and 13 s, `replayed` saying which replayed;
    the ring also holds the planning realize before them and a replay
    after them."""
    marks = [Span(t, t + 0.001, t + 0.101, t + 0.102)
             for t in (10, 11, 12, 13)]
    ring = [_record(0, 5.0, 6.5, False)]
    ring += [_record(k + 1, s.call + 0.0001, s.ret - 0.0001, r)
             for k, (s, r) in enumerate(zip(marks, replayed))]
    ring.append(_record(5, 14.0, 14.1, True))
    return marks, ring


@pytest.mark.parametrize("replayed,want", [
    ((True, True, True, True), 100.0),
    ((False, True, True, True), 75.0),
    ((False, False, False, False), 0.0)])
def test_replay_share_is_the_windows_realizes_that_replayed(replayed, want,
                                                           monkeypatch):
    marks, ring = _window(replayed)
    monkeypatch.setattr(spans, "recent", lambda: ring)
    assert _read({"spans": marks}) == pytest.approx(want)


def test_replay_share_is_none_where_the_ring_lost_a_frame(monkeypatch):
    marks, ring = _window((True,) * 4)
    monkeypatch.setattr(spans, "recent", lambda: ring[:1] + ring[2:])
    assert _read({"spans": marks}) is None
    assert _read({"spans": []}) is None


def test_a_port_that_replays_nothing_reads_nothing(monkeypatch):
    """The parent's port has spans but no `ht.replay` kind, or no spans at
    all: the reader gives None there, and raises nothing."""
    import halide_tpu_torch
    marks, _ring = _window((True,) * 4)
    monkeypatch.setattr(spans, "KINDS", tuple(
        k for k in spans.KINDS if k != "ht.replay"))
    assert _read({"spans": marks}) is None
    monkeypatch.setitem(sys.modules, "halide_tpu_torch.spans", None)
    monkeypatch.delattr(halide_tpu_torch, "spans")
    assert _read({"spans": marks}) is None


def test_the_ring_holds_a_window_of_millisecond_frames():
    """Every reader that goes through `spans.within` reads nothing where the
    ring dropped a frame of the window: a replayed camera_pipe frame takes
    about 3 ms on an H100, so the ring holds a whole window of frames of a
    millisecond, with room for the set-up's and the profile's realizes."""
    from bench_h100.spec import load_json
    seconds = load_json(HERE.parent / "BENCHMARK.json")["run_seconds"]
    assert spans.CAPACITY >= 1.2 * seconds * 1000

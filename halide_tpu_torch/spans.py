"""Host-time spans and counters of a realize.

Each realize (the outermost call of `Pipeline.realize`) writes one record
into a bounded ring: its sequence number, its start and end on the host's
clock (`time.perf_counter_ns`, the clock of `time.perf_counter`), whether
it hit the plan cache, and for each span kind its count, its total and its
self time (the total less the time its child spans cover). The kinds are
fixed (`KINDS`), so that times add up by kind, and nest so:

    ht.realize                     Pipeline.realize, the whole call
      ht.prepare                   Pipeline._prepare
        ht.gather_graph            gather_graph, or its last walk reused
          ht.graph_reuse           a mark, of no work, where it was reused
        ht.plan_key                regions, inputs, params, the chosen
                                   specializations, memo presets, the key
        ht.plan_build              _build_fn, on a plan-cache miss
      ht.run                       the plan's run
        ht.bounds                  the bounds pass, on a plan's first run
        ht.stage                   a whole-array stage (_evaluate_func)
          ht.contract              a library contraction of the stage:
                                   cuDNN's convolution (eval_torch.
                                   try_conv_reduce) or torch.einsum
                                   (try_einsum_reduce), f32 and f64
          ht.scan                  a linear recurrence of the stage's
                                   update handed to the scan kernel K2
                                   (updates._try_scan)
        ht.k1                      group_kernel.try_group
          ht.k1.plan               plan_group, on a group's first realize
          ht.k1.launch             group_kernel.launch
        ht.replay                  the plan's CUDA graph replayed: the
                                   inputs copied in, the replay, the
                                   outputs copied out (plan_graph)

A realize that replays its plan's graph runs neither `ht.stage` nor
`ht.contract` nor `ht.scan`, nor counts a contraction's lowering (`counters()`'s
contract.*): the kernels replay, the host code that chose them does not.

A kind's total counts the time of its outermost spans only, so a realize
nested in another (a memoized stage's sub-pipeline) adds its count and its
self time but no time twice. A span opened outside a realize records
nothing.

Recording is always on: with no profiler running, a span costs a check and
two clock reads. While a `torch.profiler` session runs, each span also
opens a profiler range of its kind's name, with the stage's or group's
Func name as its argument `func` where the session records shapes. The
ranges are `_RecordFunctionFast` ranges, of function scope: host events on
the kernels' clock, which the profiler does not copy onto the device's
timeline, as it does a `record_function` range (user scope).

`recent()` gives the ring's records, oldest first; `within(intervals)`
those of the realizes inside given host-clock intervals; `totals()` the
totals by kind of every realize since the process started; `counters()`
the port's counters in one snapshot. Realizes run on one thread: the open
spans and the ring are the process's.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional

import numpy as np
import torch

KINDS = ("ht.realize", "ht.prepare", "ht.gather_graph", "ht.plan_key",
         "ht.plan_build", "ht.run", "ht.bounds", "ht.stage", "ht.k1",
         "ht.k1.plan", "ht.k1.launch", "ht.replay", "ht.contract",
         "ht.graph_reuse", "ht.scan")
(REALIZE, PREPARE, GATHER_GRAPH, PLAN_KEY, PLAN_BUILD, RUN, BOUNDS, STAGE,
 K1, K1_PLAN, K1_LAUNCH, REPLAY, CONTRACT, GRAPH_REUSE, SCAN) = \
    range(len(KINDS))
# records the ring keeps: a 51-s window of realizes of 0.2 ms each and
# more (camera_pipe at 2560x1920 realizes a frame in about 0.7 ms on an
# H100, some 72,500 frames in 51 s), 361 bytes each, whose pages are
# taken as they are written
CAPACITY = 1 << 18

_clock = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast

_stack: List["span"] = []            # the open spans, innermost last
_open = [0] * len(KINDS)             # open spans of each kind
# the open realize's count, total and self ns by kind
_ZEROS = (0,) * len(KINDS)
_count = list(_ZEROS)
_total = list(_ZEROS)
_self = list(_ZEROS)


class _Ring:
    """The last `CAPACITY` realizes' records, in preallocated arrays, and
    the totals by kind of every realize written."""

    def __init__(self):
        n, k = CAPACITY, len(KINDS)
        self.capacity = n
        self.written = 0
        self.seq = np.zeros(n, np.int64)
        self.start = np.zeros(n, np.int64)
        self.end = np.zeros(n, np.int64)
        self.hit = np.zeros(n, np.bool_)
        # [record, (count, total ns, self ns), kind]
        self.times = np.zeros((n, 3, k), np.int64)
        self.sums = np.zeros((3, k), np.int64)

    def write(self, start: int, end: int) -> None:
        i = self.written % self.capacity
        self.seq[i] = self.written
        self.start[i] = start
        self.end[i] = end
        self.hit[i] = _count[PREPARE] > 0 and _count[PLAN_BUILD] == 0
        self.times[i] = (_count, _total, _self)
        self.sums += self.times[i]
        self.written += 1


_ring = _Ring()


class span:
    """`with span(kind, func_name):` one span of `kind` (an index into
    KINDS); `func_name` goes with its profiler range."""
    __slots__ = ("kind", "func", "t0", "child", "rng")

    def __init__(self, kind: int, func: Optional[str] = None):
        self.kind = kind
        self.func = func

    def __enter__(self):
        if not _stack:
            if self.kind != REALIZE:
                self.t0 = -1                 # outside a realize
                return self
            _count[:] = _total[:] = _self[:] = _ZEROS
        self.rng = None
        if _profiling():
            self.rng = (_Range(KINDS[self.kind], (), {"func": self.func})
                        if self.func is not None
                        else _Range(KINDS[self.kind]))
            self.rng.__enter__()
        self.child = 0
        _open[self.kind] += 1
        _stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        if self.t0 < 0:
            return False
        _stack.pop()
        k, dur = self.kind, t1 - self.t0
        _count[k] += 1
        _self[k] += dur - self.child
        _open[k] -= 1
        if not _open[k]:
            _total[k] += dur
        if _stack:
            _stack[-1].child += dur
        else:
            _ring.write(self.t0, t1)
        if self.rng is not None:
            self.rng.__exit__(None, None, None)
        return False


def _by_kind(times) -> Dict[str, dict]:
    count, total, self_ = times
    return {name: {"count": c, "total_ns": t, "self_ns": s}
            for name, c, t, s in zip(KINDS, count, total, self_)}


def recent() -> List[dict]:
    """The ring's records, oldest first: {"seq", "start_ns", "end_ns",
    "hit", "spans": {kind: {"count", "total_ns", "self_ns"}}}."""
    r = _ring
    n = min(r.written, r.capacity)
    idx = np.arange(r.written - n, r.written) % r.capacity
    times = r.times[idx].tolist()
    return [{"seq": q, "start_ns": s, "end_ns": e, "hit": h,
             "spans": _by_kind(t)}
            for q, s, e, h, t in zip(r.seq[idx].tolist(),
                                     r.start[idx].tolist(),
                                     r.end[idx].tolist(),
                                     r.hit[idx].tolist(), times)]


def within(intervals) -> Optional[List[dict]]:
    """The ring's records of the realizes that ran inside the host-clock
    intervals [(start ns, end ns)], in order; None where the ring holds no
    realize inside one of them (it ran none, or the ring has dropped it)."""
    recs = recent()
    starts = [r["start_ns"] for r in recs]
    out = []
    for lo, hi in intervals:
        i = bisect.bisect_left(starts, lo)
        got = []
        while i < len(recs) and recs[i]["end_ns"] <= hi:
            got.append(recs[i])
            i += 1
        if not got:
            return None
        out += got
    return out


def totals() -> Dict[str, dict]:
    """{kind: {"count", "total_ns", "self_ns"}} over every realize since
    the process started, those the ring no longer holds too."""
    return _by_kind(_ring.sums.tolist())


def counters() -> Dict[str, int]:
    """The port's counters, read where they are kept: the plan cache's
    hits and misses and the graph walks reused and made (pipeline), the
    plans' CUDA graphs captured and replayed and the hits on the card that
    ran eager (plan_graph), the libraries built and loaded (ops/build),
    each kernel's launches, the contractions lowered on eager realizes
    by path: update definitions (updates.reduce_path_counts) and, on the
    two library paths, inline sums (eval_torch.reduce_paths), the
    whole-array stages on eager realizes that the stage kernel computed
    and that it left to eval_torch on the card (ops/stage_kernel), and
    the root lifetimes (pipeline.roots): the stage arrays dropped after
    their last reader, and the largest bytes of them live at once in the
    last eager run."""
    from . import eval_torch, pipeline, plan_graph, updates
    from .ops import (build, group_kernel, rowhist_kernel, scan_kernel,
                      stage_kernel)
    upd, inline = updates.reduce_path_counts, eval_torch.reduce_paths
    return {"plan_cache.hits": pipeline.plan_cache["hits"],
            "plan_cache.misses": pipeline.plan_cache["misses"],
            "graph_cache.hits": pipeline.graph_cache["hits"],
            "graph_cache.misses": pipeline.graph_cache["misses"],
            "plan_graph.captures": plan_graph.captures,
            "plan_graph.replays": plan_graph.replays,
            "plan_graph.fallbacks": plan_graph.fallbacks,
            "kernels.built": len(build.builds),
            "kernels.loaded": len(build._LIBS),
            "group_kernel.launches": group_kernel.launches,
            "scan_kernel.launches": sum(scan_kernel.launches.values()),
            "rowhist_kernel.launches": rowhist_kernel.launches,
            "contract.conv": upd["conv"] + inline["conv"],
            "contract.einsum": upd["einsum"] + inline["einsum"],
            "contract.unrolled": upd["unrolled"],
            "contract.dense": upd["dense"],
            "stage_kernel.fused": stage_kernel.fused,
            "stage_kernel.declined": stage_kernel.declined,
            "roots.released": pipeline.roots["released"],
            "roots.peak_bytes": pipeline.roots["peak_bytes"]}

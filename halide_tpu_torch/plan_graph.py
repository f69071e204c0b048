"""A planned realize replayed as one CUDA graph.

A realize that hits the plan cache on the card makes the same launches, with
the same shapes and in the same order, as the realize before it: only the
data of its inputs differs. So the plan's `run` is captured once into a
`torch.cuda.CUDAGraph`, on the plan's `_CAPTURE_HIT`-th hit, and replayed
on every hit after it: each bound input is copied into the graph's static
input, the graph is replayed, and each output is copied out of the graph's
memory into a fresh tensor of the shape, strides and dtype that the eager
realize returns (a caller may keep the outputs of many frames). The card
does the same work, kernel for kernel; a replay adds one copy of each input
and of each output.

The plan's first realize (its miss) stays eager, as do its hits before the
`_CAPTURE_HIT`-th: the miss plans, bounds and builds or loads K1, and
leaves warm what the capture needs. A plan is captured only
where nothing it runs goes to the host or depends on a call's host state
(`why_not`): no trace, no memoized or extern stage, no print, print_when or
require, no debug_to_file dump, no distribute record. A call on a captured
plan runs eager where `why_not_now` finds a reason: an input off the card or
requiring a gradient, another capture open, or the groups planned and not
computed (`group_kernel.planning`) or exported. A capture that raises
leaves the plan eager for good, and its realize runs eager. A CPU realize
never captures.

`Pipeline._run` calls `run`; the other callers of a plan's `run` (the shards
of `parallel/distribute.py`, `derivative`'s traced Params) stay eager. The
graphs live on the plan-cache entry (`run.replays`, by the `groups` flag),
each with its own memory pool, and the process keeps few of them: before a
capture, the least recently replayed graphs are dropped until fewer than
`_KEEP` are kept and those hold at most `_KEEP_SHARE` of the card's memory
(a 50 MP local_laplacian's graph holds about 25 GB). A dropped graph's plan
runs eager from then on, so that plans taking turns never capture again
and again. A Pipeline and its plans are freed only by Python's cycle
collector (each plan's `run` refers to its Pipeline), so where the bound
is reached the capture first collects: dead plans (a profile's prefixes,
an autoscheduler's candidates) free their graphs before a live one is
dropped.

Counters: `captures`, `replays` (every replay, the one that ends a capture
too) and `fallbacks` (hits on the card that ran eager where the plan could
not replay); `last_fallback` names the reason of the last fallback.
"""
from __future__ import annotations

import gc
import weakref
from typing import List, Optional

import torch

from . import expr as E
from . import spans
from .visitors import walk

captures = 0
replays = 0
fallbacks = 0
last_fallback: Optional[str] = None

# a plan is captured on this hit of its plan-cache entry; its hits before
# it run eager. A capture costs more than an eager realize (on an H100,
# some 95-245 ms more at 2560x1920 and 1536x2560), which replays win back
# only over several frames: a plan realized twice never pays it
_CAPTURE_HIT = 2
# the graphs the process keeps beside a new capture: fewer than _KEEP, and
# holding at most this share of the card's memory
_KEEP = 4
_KEEP_SHARE = 0.25
# the reason a plan whose graph was dropped runs eager
DROPPED = "its graph was dropped for a newer plan's"
# the graphs kept, least recently replayed first (weak: a graph goes with
# its plan-cache entry)
_kept: List[weakref.ref] = []

# intrinsics that read a value back to the host on every call
_HOST_INTRINSICS = ("print", "print_when", "require")
# graphs whose capture raised: torch's allocator may keep the capture's
# routing entry, which reads the graph object, so the object is kept
_failed: List[torch.cuda.CUDAGraph] = []


class Captured:
    """A plan's graph: its static inputs and outputs (per output, a tuple
    of tensors), the launches of the port's kernels one replay makes
    (group, scan by body, row histogram), and where it is kept (the plan's
    `replays` and its key there) with the device memory it holds."""
    __slots__ = ("graph", "inputs", "outputs", "launches", "owner", "key",
                 "nbytes", "__weakref__")

    def __init__(self, graph, inputs, outputs, launches, owner=None,
                 key=None, nbytes=0):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.owner = owner
        self.key = key
        self.nbytes = nbytes


def why_not(pipeline, g) -> Optional[str]:
    """Why the plan of `pipeline` over its gathered graph `g` cannot be
    replayed as a graph, or None where it can."""
    from .pipeline import _all_def_exprs
    if pipeline.trace is not None:
        return "a trace is installed"
    found: List[str] = []

    def host(n):
        if isinstance(n, E.Intrin) and n.name in _HOST_INTRINSICS:
            found.append(n.name)
    for f in g.funcs:
        fs = f._fschedule
        if fs.trace_loads or fs.trace_stores or fs.trace_realizations:
            return f"{f.name} is traced"
        if f.is_extern():
            return f"{f.name} is an extern stage"
        if fs.memoized and id(f) in g.materialized \
                and not any(f is o for o in pipeline.outputs):
            return f"{f.name} is memoized"
        if fs.debug_file:
            return f"{f.name} dumps to a file"
        if fs.distributed is not None:
            return f"{f.name} has a distribute record"
        for e in _all_def_exprs(f):
            walk(e, host)
        if found:
            return f"{f.name} calls {found[0]}"
    return None


def why_not_now(dev: torch.device, inputs) -> Optional[str]:
    """Why this call cannot replay a captured plan, or None where it can."""
    if dev.type != "cuda" or any(a.device.type != "cuda" for a in inputs):
        return "an input is not on the card"
    if torch.is_grad_enabled() and any(a.requires_grad for a in inputs):
        return "an input requires a gradient"
    if torch.cuda.is_current_stream_capturing():
        return "another capture is open"
    from .ops import export_ops, group_kernel
    if group_kernel._PLANNING[0] is not None:
        return "the groups are planned, not computed"
    if export_ops.exporting():
        return "a program is being exported"
    return None


def run(pipeline, plan, inputs, presets, groups: bool, dev: torch.device):
    """The outputs of `plan` (a plan-cache entry's `run`) on `inputs`, as
    `plan(inputs, presets, groups)` gives them: eager on the CPU and on the
    plan's first runs, else through its graph, captured on this call where
    it has none yet."""
    global fallbacks, last_fallback
    if dev.type != "cuda" or "boxes" not in plan.planned:
        return plan(inputs, presets, groups)
    # a Captured, the reason the plan stays eager, or its hits so far
    state = plan.replays.get(groups)
    if state is None:
        state = plan.replays[groups] = why_not(pipeline, plan.func_graph) \
            or 0
    reason = state if isinstance(state, str) else why_not_now(dev, inputs)
    if reason is not None:
        fallbacks += 1
        last_fallback = reason
        return plan(inputs, presets, groups)
    if isinstance(state, int):
        if state + 1 < _CAPTURE_HIT:
            plan.replays[groups] = state + 1
            return plan(inputs, presets, groups)
        return _capture(plan, inputs, groups, dev)
    with spans.span(spans.REPLAY):
        _add_launches(state.launches)
        if groups:
            _k1_records(plan)
        _touch(state)
        return _replay(state, inputs)


def _k1_records(plan) -> None:
    """Leave K1's records as the eager run leaves them."""
    from .ops import group_kernel
    for gp in plan.planned["groups"].values():
        if gp:
            group_kernel.note_plan(gp.f.name, gp.recorded)


def kept() -> List[Captured]:
    """The graphs the process keeps, least recently replayed first."""
    return [c for c in (r() for r in _kept) if c is not None]


def _touch(cap: Captured) -> None:
    """Make `cap` the most recently replayed graph."""
    for i, r in enumerate(_kept):
        if r() is cap:
            if i != len(_kept) - 1:
                _kept.append(_kept.pop(i))
            return


def _over(graphs: List[Captured], dev: torch.device) -> bool:
    room = _KEEP_SHARE * torch.cuda.get_device_properties(dev).total_memory
    return len(graphs) >= _KEEP or sum(c.nbytes for c in graphs) > room


def _make_room(dev: torch.device) -> None:
    """Drop the least recently replayed graphs until a new one is within
    the bound (`_KEEP`, `_KEEP_SHARE`); the dead plans' graphs go first.
    A full collection costs a capture some 150 ms more on an H100, so it
    runs only where the bound is reached."""
    _kept[:] = [r for r in _kept if r() is not None]
    if not _over(kept(), dev):
        return
    gc.collect()
    graphs = kept()
    while graphs and _over(graphs, dev):
        old = graphs.pop(0)
        old.owner[old.key] = DROPPED
        del old
    _kept[:] = [weakref.ref(c) for c in graphs]


def _launches() -> tuple:
    from .ops import group_kernel, rowhist_kernel, scan_kernel
    return (group_kernel.launches, dict(scan_kernel.launches),
            rowhist_kernel.launches)


def _add_launches(n: tuple) -> None:
    from .ops import group_kernel, rowhist_kernel, scan_kernel
    group_kernel.launches += n[0]
    for body, k in n[1].items():
        scan_kernel.launches[body] += k
    rowhist_kernel.launches += n[2]


def _capture(plan, inputs, groups: bool, dev: torch.device):
    """Capture `plan`'s run on static copies of `inputs` and replay it once;
    -> the outputs. A capture that raises leaves the plan eager for good
    and runs it eager."""
    global captures, fallbacks, last_fallback
    static = [torch.empty_like(a) for a in inputs]
    for s, a in zip(static, inputs):
        s.copy_(a)
    # the graphs dropped and the eager pool's cached blocks go back first,
    # so the graph's pool takes their place rather than sitting beside them
    torch.cuda.synchronize(dev)
    _make_room(dev)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    graph = torch.cuda.CUDAGraph()
    before = _launches()
    # no garbage collection inside the capture: a dead plan's graph freed
    # there could not be destroyed
    collecting, err = gc.isenabled(), None
    gc.disable()
    try:
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outs = plan(static, None, groups)
            except BaseException:
                _end_failed(graph)
                raise
            graph.capture_end()
    except Exception as ex:     # noqa: BLE001 -- the realize runs eager
        err = ex
    finally:
        if collecting:
            gc.enable()
    if err is not None:
        plan.replays[groups] = reason = (f"the capture raised "
                                         f"{type(err).__name__}: {err}")
        fallbacks += 1
        last_fallback = reason
        # the launches were recorded, not run
        _add_launches(_minus(before, _launches()))
        return plan(inputs, None, groups)
    # the capture counted its launches once, as the replay below runs them
    cap = Captured(graph, static, outs, _minus(_launches(), before),
                   plan.replays, groups,
                   torch.cuda.memory_reserved(dev) - reserved
                   + sum(s.nbytes for s in static))
    plan.replays[groups] = cap
    _kept.append(weakref.ref(cap))
    captures += 1
    with spans.span(spans.REPLAY):
        return _replay(cap, None)


def _end_failed(graph) -> None:
    """End a capture that raised (`capture_end` raises in turn where the
    capture was invalidated)."""
    try:
        graph.capture_end()
    except RuntimeError:
        _failed.append(graph)


def _minus(a: tuple, b: tuple) -> tuple:
    """The launches `a` less `b`, by kernel."""
    return (a[0] - b[0], {k: a[1][k] - b[1].get(k, 0) for k in a[1]},
            a[2] - b[2])


def _replay(cap: Captured, inputs):
    """Copy `inputs` (None: already in place) into the static inputs,
    replay, and copy each output out into a fresh tensor."""
    global replays
    if inputs is not None:
        for s, a in zip(cap.inputs, inputs):
            if a.data_ptr() != s.data_ptr() or a.stride() != s.stride():
                s.copy_(a)
    cap.graph.replay()
    replays += 1
    return tuple(tuple(torch.empty_strided(
        v.shape, v.stride(), dtype=v.dtype, device=v.device).copy_(v)
        for v in vals) for vals in cap.outputs)

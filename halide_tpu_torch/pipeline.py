"""Pipeline: lowering and execution (counterpart of the JAX package's
pipeline.py).

The analog of the reference's Pipeline/realize path (reference:
src/Pipeline.cpp:512-1024, src/Lower.cpp:136-608). Lowering here is:

1. gather the func graph (reference: RealizationOrder.cpp / FindCalls.cpp)
2. pick materialized vs inlined stages from the schedules
3. required-region inference outside-in (reference: BoundsInference.cpp)
4. evaluate each materialized stage whole-array in torch (eval_torch), its
   update definitions applied in order (updates); a tiled Func with
   `compute_at` producers goes to the stencil-group kernel
   (ops/group_kernel), one launch for the group; a stage's arrays are
   dropped after the last stage that reads them (root lifetimes: the
   outputs and the memoized, traced and dumped stages are kept to the end)
5. cache the planned graph (bounds and group plans) per graph, sizes and
   bound inputs, so a repeated realize only executes; on the card, it
   replays the plan captured as one CUDA graph (plan_graph)

Around that loop: specialization ladders resolved per realize (specialize),
memoized stages fetched from the native LRU (runtime), extern stages run on
the host, traces and debug_to_file dumps of what each stage produced, the
target's features, and `profile`, `compile_to_callable` and
`infer_input_bounds`.

Everything runs on the realize device: the card unless the caller asks for
the CPU. Where there is no card and none was asked for, realize raises.
What goes to the host on the card: an extern stage's inputs and result, a
memoized stage's inputs for its key (up to 8 MB each) and its value on a
miss, a trace's store payloads, a debug_to_file dump, and a print's value.
"""
from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import expr as E
from . import spans
from .bounds import BoundsEngine, Box, Interval
from .buffer import Buffer, ImageParam, Param, Realization
from .eval_torch import Axis, Ctx, Realized, eval_array, full_shape, static_int
from .expr import CompileError, Expr
from .func import Func, definition_epoch
from .hooks import to_numpy
from .htypes import compute_dtype, torch_dtype
from .visitors import walk

__all__ = ["Pipeline", "resolve_device"]

# the last realize's memo lookups: the seconds spent hashing the keys (the
# sub-pipelines' inputs read back from the card), and the memoized Funcs
# that hit and missed
last_memo: dict = {}
# the last extern stage's host round trip: seconds to copy its cropped
# inputs off the device, to run its callback and to copy the result back,
# and the bytes each way
last_extern: dict = {}
# plan-cache lookups of every Pipeline's `_prepare` in this process
plan_cache = {"hits": 0, "misses": 0}
# graph walks `_prepare` reused (hits) and made (misses) in this process
graph_cache = {"hits": 0, "misses": 0}
# root lifetimes: the stage arrays a plan's runs dropped after their last
# reader, since the process started (`released`), and the largest total
# bytes of the stage arrays live at once in the last run (`peak_bytes`)
roots = {"released": 0, "peak_bytes": 0}


def resolve_device(device=None) -> torch.device:
    """`None` means the card. Asking for the card where there is none
    raises: nothing carries on on the CPU unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "realize needs a CUDA device and torch sees none; pass "
            "device='cpu' to run on the CPU")
    return dev


class _Graph:
    def __init__(self):
        self.funcs: List[Func] = []          # topo order, producers first
        self.materialized: Dict[int, Func] = {}
        self.inputs: Dict[int, object] = {}  # ImageParam/Buffer by id
        self.params: Dict[int, Param] = {}


def _all_def_exprs(f: Func):
    for d in f._defs:
        yield from d.values
        for a in d.args:
            if isinstance(a, Expr):
                yield a
        yield from d.predicates
        if d.rdom is not None:
            for rv in d.rdom.dims:
                if rv.rmin is not None:
                    yield rv.rmin
                if rv.rextent is not None:
                    yield rv.rextent
    # specialization conditions reference params/input dims that must enter
    # the plan-cache key (they select the variant)
    for s in f._specializations:
        yield s.condition


def _scan_expr_targets(e: Expr, on_func, on_input, on_param):
    def fn(n):
        if isinstance(n, E.Call):
            if isinstance(n.target, Func):
                on_func(n.target)
            else:
                on_input(n.target)
        elif isinstance(n, E.Intrin):
            if n.name == "param":
                on_param(n.args[0])
            elif n.name in ("buffer_min", "buffer_extent"):
                on_input(n.args[0])
        elif isinstance(n, E.Reduce):
            for rv in n.rdom.dims:
                for b in (rv.rmin, rv.rextent):
                    if b is not None:
                        walk(b, fn)
            for p in n.rdom.predicates:
                walk(p, fn)

    walk(e, fn)


def _want_materialize(f: Func) -> bool:
    if f.is_extern():
        return True
    lvl = f._fschedule.compute_level
    if lvl.is_inlined():
        if len(f._defs) > 1:
            raise CompileError(
                f"Func {f.name} with update definitions cannot be inlined")
        return False
    if lvl.is_root() or lvl.kind == "at":
        return True
    # defaults: inline pure single-value defs; materialize the rest
    return (len(f._defs) > 1 or len(f._defs[0].values) > 1
            or f._fschedule.memoized or bool(f._specializations)
            or any(d.schedule.fused_with for d in f._defs))


def _materialized(funcs: List[Func], outputs: List[Func]) -> Dict[int, Func]:
    """The stages that get a buffer, by the schedules as they are now."""
    return {id(f): f for f in funcs
            if f in outputs or _want_materialize(f)}


def gather_graph(outputs: List[Func]) -> _Graph:
    g = _Graph()
    seen: Dict[int, Func] = {}
    order: List[Func] = []
    visiting: set = set()

    def visit(f: Func):
        if id(f) in seen:
            return
        if id(f) in visiting:
            raise CompileError(f"cyclic func graph at {f.name}")
        if not f.defined():
            raise CompileError(f"Func {f.name} is used before it is defined")
        visiting.add(id(f))
        if f.is_extern():
            for src in f._extern["inputs"]:
                if isinstance(src, Func):
                    visit(src)
                else:
                    g.inputs.setdefault(id(src), src)
        for e in _all_def_exprs(f):
            _scan_expr_targets(
                e,
                on_func=lambda t: t is not f and visit(t),
                on_input=lambda t: g.inputs.setdefault(id(t), t),
                on_param=lambda p: g.params.setdefault(id(p), p),
            )
        visiting.discard(id(f))
        seen[id(f)] = f
        order.append(f)

    for f in outputs:
        visit(f)
    g.funcs = order
    g.materialized = _materialized(order, outputs)
    return g


def _fusion_cliques(g: _Graph) -> Dict[int, List[Func]]:
    """compute_with cliques among materialized funcs: id(member) -> clique
    (funcs in dependency order). Members must be mutually independent
    (reference: Func::compute_with legality, src/ScheduleFunctions.cpp)."""
    parent: Dict[int, int] = {}

    def find(a):
        while parent.get(a, a) != a:
            parent[a] = parent.get(parent[a], parent[a])
            a = parent[a]
        return a

    by_id = {id(f): f for f in g.funcs}
    for f in g.funcs:
        for d in f._defs:
            for (other, _var, *_align) in d.schedule.fused_with:
                of = other[0] if isinstance(other, tuple) else other
                if id(of) in by_id and id(f) in g.materialized \
                        and id(of) in g.materialized \
                        and not f.is_extern() and not of.is_extern():
                    ra, rb = find(id(f)), find(id(of))
                    if ra != rb:
                        parent[ra] = rb
    if not parent:
        return {}
    groups: Dict[int, List[Func]] = {}
    for f in g.funcs:
        if id(f) in g.materialized:
            groups.setdefault(find(id(f)), []).append(f)
    out: Dict[int, List[Func]] = {}
    for clique in groups.values():
        if len(clique) < 2:
            continue
        ids = {id(m) for m in clique}
        for m in clique:
            for e in _all_def_exprs(m):
                def check(n, m=m):
                    if isinstance(n, E.Call) and id(n.target) in ids \
                            and n.target is not m:
                        raise CompileError(
                            f"compute_with: {m.name} reads "
                            f"{n.target.name}; fused stages must be "
                            f"independent")
                walk(e, check)
        for m in clique:
            out[id(m)] = clique
    return out


def _steps(g: _Graph, boxes, cliques) -> List[tuple]:
    """A plan's run in order, as (kind, Func, members) steps: "stage" a
    materialized Func with the Funcs computed at it (a K1 group, or each
    evaluated alone before it), "clique" a compute_with clique lowered
    together when its last member is met, "tail" the members whose anchor
    the run never evaluates, alone, at the end."""
    steps: List[tuple] = []
    deferred: Dict[int, List[Func]] = {}
    for f in g.funcs:
        box = boxes.get(id(f))
        if id(f) not in g.materialized or box is None or not box.defined():
            continue
        lvl = f._fschedule.compute_level
        if lvl.kind == "at" and id(lvl.func) in g.materialized:
            deferred.setdefault(id(lvl.func), []).append(f)
            continue
        clique = cliques.get(id(f))
        if clique is not None:
            if f is clique[-1]:
                steps.append(("clique", f, list(clique)))
            continue
        steps.append(("stage", f, deferred.pop(id(f), [])))
    tail = [m for ms in deferred.values() for m in ms]
    if tail:
        steps.append(("tail", None, tail))
    return steps


def _stage_reads(f: Func, g: _Graph) -> set:
    """The materialized Funcs f's definitions read (through the inline
    Funcs they call), f itself left out."""
    out: set = set()
    seen: set = set()

    def note(t):
        if t is f or not isinstance(t, Func):
            return
        if id(t) in g.materialized:
            out.add(id(t))
        elif id(t) not in seen:
            seen.add(id(t))
            scan(t)

    def scan(t):
        if t.is_extern():
            for src in t._extern["inputs"]:
                note(src)
        for e in _all_def_exprs(t):
            _scan_expr_targets(e, note, lambda _t: None, lambda _p: None)

    scan(f)
    return out


def _kept_roots(g: _Graph, outputs: List[Func], presets) -> set:
    """The stages a run keeps to its end: the outputs, the memoized
    stages (and presets), and the traced or dumped ones."""
    keep = {id(f) for f in outputs} | set(presets)
    for f in g.funcs:
        fs = f._fschedule
        if fs.memoized or fs.trace_loads or fs.trace_stores \
                or fs.trace_realizations or fs.debug_file:
            keep.add(id(f))
    return keep


def _last_readers(steps: List[tuple], g: _Graph, keep: set) -> List[list]:
    """For each step, the materialized Funcs to drop after it: those it
    reads last (`_stage_reads` of its Funcs), and those it makes that no
    step reads; never one of `keep`. A Func that runs is dropped after the
    step that makes it at the earliest."""
    last: Dict[int, int] = {}
    for k, (kind, f, members) in enumerate(steps):
        made = members + ([f] if kind == "stage" else [])
        for m in made:
            last.setdefault(id(m), k)
        for m in made:
            for fid in _stage_reads(m, g):
                last[fid] = k
    drops: List[list] = [[] for _ in steps]
    for fid, k in last.items():
        if fid not in keep:
            drops[k].append(fid)
    return drops


# ---------------------------------------------------------------------------
# bounds inference
# ---------------------------------------------------------------------------

# Largest per-dim extent bounds inference will size a required region to
# (the reference's 2^31-element allocation guard,
# src/BoundSmallAllocations.cpp); _too_big_region caps the product of the
# extents at the same count.
_MAX_REGION_EXTENT = 1 << 31


def _unreasonable(iv) -> bool:
    return (iv.hi - iv.lo + 1) > _MAX_REGION_EXTENT


def _too_big_region(box) -> bool:
    total = 1
    for iv in box.dims:
        total *= max(iv.hi - iv.lo + 1, 1)
        if total > _MAX_REGION_EXTENT:
            return True
    return False


class _BoundsPass:
    def __init__(self, g: _Graph, engine: BoundsEngine):
        self.g = g
        self.engine = engine
        self.boxes: Dict[int, Box] = {}

    def input_box(self, t) -> Box:
        return self.boxes.setdefault(id(t), Box.empty(t.dimensions()))

    def run(self, outputs: List[Func], out_regions: Dict[int, Box]):
        for f in outputs:
            self.boxes[id(f)] = out_regions[id(f)]
        # consumers first
        for f in reversed(self.g.funcs):
            if id(f) not in self.g.materialized:
                continue
            box = self.boxes.get(id(f))
            if box is None or not box.defined():
                continue      # materialized but unused
            self._self_fixpoint(f, box)
            if _too_big_region(box):
                raise CompileError(
                    f"required region of {f.name} exceeds "
                    f"{_MAX_REGION_EXTENT} total elements (accessed over an "
                    "unreasonably large range); add clamp() or bound()")
            self._footprints(f, box)

    def _def_scope(self, f: Func, d, box: Box) -> Dict[str, Interval]:
        """Pure vars over the box, RVars over their ranges."""
        scope: Dict[str, Interval] = {}
        for i, v in enumerate(f._args):
            scope[v.name] = box.dims[i]
        if d.rdom is not None:
            for rv in d.rdom.dims:
                mn = self.engine.bounds(rv.rmin, scope)
                ex = self.engine.bounds(rv.rextent, scope)
                scope[rv.name] = Interval(mn.lo, mn.hi + ex.hi - 1)
        return scope

    def _self_fixpoint(self, f: Func, box: Box):
        """Grow box[f] to cover its own updates' reads and writes."""
        if f.is_extern():
            return
        for _ in range(16):
            changed = False
            for d in f._defs[1:]:
                scope = self._def_scope(f, d, box)
                ivs = [(i, a) for i, a in enumerate(d.args)]
                for e in list(d.values) + list(d.predicates):
                    for call in _find_calls_to(e, f):
                        ivs.extend(enumerate(call.args))
                for i, a in ivs:
                    iv = self.engine.bounds(a, scope)
                    if not iv.is_bounded():
                        raise CompileError(
                            f"{f.name}: cannot bound update access on dim "
                            f"{i}: {a!r}")
                    old = box.dims[i]
                    box.union_dim(i, iv)
                    if box.dims[i] != old:
                        changed = True
            if not changed:
                return
        raise CompileError(f"{f.name}: self-bounds did not converge")

    def _footprints(self, f: Func, box: Box):
        if f.is_extern():
            # double bounds-query protocol (reference:
            # BoundsInference.cpp:452-506): first let the stage round UP the
            # output region it will actually produce, then size the inputs
            # from that rounded region
            bq = f._extern.get("bounds_query")
            if bq is not None:
                box.union(bq(Box(list(box.dims))))
            for src, b2 in zip(f._extern["inputs"], _extern_boxes(f, box)):
                self.boxes.setdefault(
                    id(src), Box.empty(src.dimensions())).union(b2)
            return
        for d in f._defs:
            scope = self._def_scope(f, d, box)
            exprs = list(d.values) + list(d.predicates) + [
                a for a in d.args if not isinstance(a, E.Variable)]
            for e in exprs:
                self._visit(e, scope, skip_self=f)

    def _visit(self, e: Expr, scope: Dict[str, Interval], skip_self=None):
        if isinstance(e, E.Call):
            for a in e.args:
                self._visit(a, scope, skip_self)
            t = e.target
            if isinstance(t, Func) and t is skip_self:
                return
            ivs = [self.engine.bounds(a, scope) for a in e.args]
            if isinstance(t, Func) and id(t) not in self.g.materialized:
                child = {v.name: iv for v, iv in zip(t.args(), ivs)}
                self._visit(t._defs[0].values[e.value_index], child)
                return
            name = getattr(t, "name", "?")
            box = self.boxes.setdefault(id(t), Box.empty(t.dimensions()))
            for i, iv in enumerate(ivs):
                if not iv.is_bounded() or _unreasonable(iv):
                    raise CompileError(
                        f"cannot bound required region of {name} dim {i} "
                        "(accessed from an unbounded index or over an "
                        "unreasonably large range); add clamp() or bound()")
                box.union_dim(i, iv)
            return
        if isinstance(e, E.Let):
            self._visit(e.value, scope, skip_self)
            child = dict(scope)
            child[e.name] = self.engine.bounds(e.value, scope)
            self._visit(e.body, child, skip_self)
            return
        if isinstance(e, E.Reduce):
            child = self.engine.rdom_scope(e.rdom, scope)
            for c in [e.value, e.where] + list(e.rdom.predicates):
                if c is not None:
                    self._visit(c, child, skip_self)
            return
        for c in e.children():
            self._visit(c, scope, skip_self)


def _extern_boxes(f: Func, box: Box) -> List[Box]:
    """The boxes an extern stage reads of its inputs to produce `box`."""
    fp = f._extern["footprint"]
    if fp is not None:
        return fp(Box(list(box.dims)))
    return [Box(list(box.dims)) for _ in f._extern["inputs"]]


def _find_calls_to(e: Expr, f: Func):
    out = []

    def fn(n):
        if isinstance(n, E.Call) and n.target is f:
            out.append(n)

    walk(e, fn)
    return out


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

class Pipeline:
    def __init__(self, outputs):
        if isinstance(outputs, Func):
            outputs = [outputs]
        self.outputs: List[Func] = list(outputs)
        self._plan_cache: Dict = {}
        # the last graph walk: (definition epoch, funcs, inputs, params)
        self._walk = None
        self.trace = None

    def _graph(self) -> _Graph:
        """gather_graph(self.outputs), its walk reused while no definition
        has changed since (`func.definition_epoch`). A reuse decides anew
        which stages are materialized: that reads the schedules."""
        epoch = definition_epoch()
        walk = self._walk
        if walk is None or walk[0] != epoch:
            graph_cache["misses"] += 1
            g = gather_graph(self.outputs)
            self._walk = (epoch, list(g.funcs), dict(g.inputs),
                          dict(g.params))
            return g
        graph_cache["hits"] += 1
        with spans.span(spans.GRAPH_REUSE):     # a mark: no work inside
            pass
        g = _Graph()
        g.funcs, g.inputs, g.params = list(walk[1]), dict(walk[2]), \
            dict(walk[3])
        g.materialized = _materialized(g.funcs, self.outputs)
        return g

    def _signature(self, g: _Graph) -> Tuple:
        sig = []
        for f in g.funcs:
            fs = f._fschedule
            sig.append((
                id(f), len(f._defs),
                fs.compute_level.kind,
                id(fs.compute_level.func) if fs.compute_level.func else 0,
                tuple(tuple((sp.kind, sp.old, repr(sp.factor))
                            for sp in d.schedule.splits) for d in f._defs),
                tuple(tuple((dm.var, dm.for_type.value)
                            for dm in d.schedule.dims) for d in f._defs),
                tuple((b.var, repr(b.min), repr(b.extent))
                      for b in fs.bounds),
                tuple(tuple((rv.name, repr(rv.rmin), repr(rv.rextent))
                            for rv in d.rdom.dims)
                      for d in f._defs if d.rdom is not None),
                fs.memoized, fs.debug_file,
            ))
        return tuple(sig)

    def _out_regions(self, sizes, dst=None) -> Dict[int, Box]:
        regions: Dict[int, Box] = {}
        if dst is not None:
            bufs = dst if isinstance(dst, (list, tuple)) else [dst]
            for f, b in zip(self.outputs, bufs):
                regions[id(f)] = Box([Interval(b.dim(i).min, b.dim(i).max())
                                      for i in range(f.dimensions())])
            return regions
        if sizes is None:
            raise CompileError("realize() needs sizes or a destination buffer")
        if isinstance(sizes, int):
            sizes = [sizes]
        for f in self.outputs:
            n = f.dimensions()
            if len(sizes) != n:
                raise CompileError(
                    f"realize: {f.name} has {n} dims, got {len(sizes)} sizes")
            box = Box([Interval(0, int(s) - 1) for s in sizes])
            for b in f._fschedule.bounds:
                if b.min is None or b.extent is None:
                    continue
                c0 = Ctx(0, {}, {}, {}, {})
                mn, ex = static_int(b.min, c0), static_int(b.extent, c0)
                for i, v in enumerate(f._args):
                    req = box.dims[i]
                    if v.name == b.var and (req.lo < mn
                                            or req.hi > mn + ex - 1):
                        raise CompileError(
                            f"{f.name}: realized region {req} exceeds "
                            f"bound({b.var}, {mn}, {ex})")
            regions[id(f)] = box
        return regions

    def _inputs(self, g: _Graph):
        """[(input, its Buffer)] of the graph; an unbound one raises."""
        input_objs = []
        for t in g.inputs.values():
            if isinstance(t, ImageParam):
                buf = t.get()
            elif isinstance(t, Buffer):
                buf = t
            else:
                raise CompileError(f"unbound input {t!r}")
            input_objs.append((t, buf))
        return input_objs

    def realize(self, sizes=None, target=None, dst=None, jit: bool = True,
                device=None, mesh=None, custom_print=None,
                custom_error=None):
        """Realize the outputs over `sizes` (or over `dst`'s region) on
        `device`: None means the card, and raises where there is none. The
        arguments come in the JAX package's order.

        `jit` selects nothing: a realize runs the same way either way (on
        the card, a plan's later realizes replay it as one CUDA graph,
        `plan_graph`). It is taken so that calls written for the JAX
        package run unchanged.

        `mesh` (a `parallel.Mesh`) with a `distribute()` record on the first
        output shards the realize over the record's mesh axis: the spatial
        path with halo exchange, or the reduction path with partials
        combined in shard order (`parallel.distribute.distributed_realize`);
        each shard runs on its slot's device, and `device` is not read. A
        mesh without a record is ignored, as in the JAX package.

        `target` (a Target or its string) is read as the JAX package reads
        it: `trace_all` arms a trace of every Func for this call,
        `no_pallas` or `interpret` evaluate every group whole-array, and
        `profile` prints `self.profile(...)` afterwards.

        custom_print / custom_error: PER-CALL handler overrides --
        installed for this realization only and restored on exit (the
        reference's JITUserContext handler table,
        src/runtime/HalideRuntime.h:178-196, installed per call at
        Pipeline.cpp:818)."""
        with spans.span(spans.REALIZE):
            if custom_print is not None or custom_error is not None:
                from . import hooks
                prev_p = hooks.set_custom_print(custom_print) \
                    if custom_print is not None else None
                prev_e = hooks.set_error_handler(custom_error) \
                    if custom_error is not None else None
                try:
                    return self.realize(sizes=sizes, target=target,
                                        dst=dst, jit=jit, device=device,
                                        mesh=mesh)
                finally:
                    if custom_print is not None:
                        hooks.set_custom_print(prev_p)
                    if custom_error is not None:
                        hooks.set_error_handler(prev_e)
            from .target import Target, get_jit_target_from_environment
            if target is None:
                target = get_jit_target_from_environment()
            elif isinstance(target, str):
                target = Target(target)
            dist = self.outputs[0]._fschedule.distributed
            if mesh is not None and dist is not None:
                from .parallel.distribute import distributed_realize
                var_name, axis_name = dist
                datas = distributed_realize(self, sizes, mesh, axis_name,
                                            var_name)
                bufs = []
                for f, d in zip(self.outputs, datas):
                    if isinstance(d, tuple):   # tuple-valued Func
                        bufs.append(Realization(
                            [Buffer(v, name=f.name) for v in d]))
                    else:
                        bufs.append(Buffer(d, name=f.name))
                return bufs[0] if len(bufs) == 1 else Realization(bufs)
            tr_installed = False
            if target.has_feature("trace_all") and self.trace is None:
                from .trace import Trace
                for f in gather_graph(self.outputs).funcs:
                    f._fschedule.trace_realizations = True
                    f._fschedule.trace_stores = True
                self.trace = Trace()
                tr_installed = True
            groups = not (target.has_feature("no_pallas")
                          or target.has_feature("interpret"))
            try:
                arrays, regions = self._run(sizes, dst, device, groups)
            finally:
                if tr_installed:
                    self.trace = None
            if target.has_feature("profile"):
                print(self.profile(sizes, dst, device=device))
            return self._package(arrays, regions, dst)

    def _run(self, sizes, dst, device, groups: bool = True):
        """Plan (or fetch from the plan cache) and run the pipeline.
        -> (per output, a tuple of tensors; the requested regions)."""
        from . import plan_graph
        from .specialize import apply_all, restore
        dev = resolve_device(device)
        run, chosen, inp_arrays, presets, regions = self._prepare(
            sizes, dst, dev)
        # the chosen variants' directives hold while the plan is made and
        # while it runs, and only then
        undo = apply_all(chosen)
        try:
            with spans.span(spans.RUN):
                return plan_graph.run(self, run, inp_arrays, presets, groups,
                                      dev), regions
        finally:
            restore(undo)

    def _prepare(self, sizes, dst, dev, memo: bool = True):
        """The executor of the graph as its inputs are bound now, on `dev`,
        from the plan cache or built and cached there: -> (run, the chosen
        specializations, the input tensors on dev, the memoized stages'
        presets, the requested regions). With `memo` False no stage is
        fetched from the memo cache: `run` computes every one (the shards
        of a distributed realize, prepared on dummy inputs)."""
        from .specialize import select
        with spans.span(spans.PREPARE):
            with spans.span(spans.GATHER_GRAPH):
                g = self._graph()
            with spans.span(spans.PLAN_KEY):
                regions = self._out_regions(sizes, dst)
                input_objs = self._inputs(g)
                inp_arrays = [buf.data.to(dev) for (_, buf) in input_objs]
                param_vals = {id(p): p.get() for p in g.params.values()}
                chosen = []
                if any(f._specializations for f in g.funcs):
                    chosen = select(g, {
                        id(t): Realized((a,), buf._mins,
                                        getattr(t, "name", "buf"))
                        for (t, buf), a in zip(input_objs, inp_arrays)},
                        param_vals, dev)
                # memoized stages come from the host LRU cache before the
                # run (reference: src/Memoization.cpp + runtime/cache.cpp)
                presets = self._memo_precompute(
                    g, input_objs, param_vals, regions, dev) if memo else {}
                key = (self._signature(g), str(dev),
                       tuple((b.mins(), b.extents())
                             for b in regions.values()),
                       tuple((id(t), tuple(buf.data.shape), buf.data.dtype,
                              buf._mins) for (t, buf) in input_objs),
                       tuple(sorted((k, repr(v))
                                    for k, v in param_vals.items())),
                       id(self.trace) if self.trace is not None else 0,
                       tuple((f._fschedule.trace_stores,
                              f._fschedule.trace_realizations)
                             for f in g.funcs),
                       tuple(id(c) for c in chosen),
                       tuple((fid, mins, tuple((tuple(a.shape), a.dtype)
                                               for a in arrs))
                             for fid, (mins, arrs) in presets.items()))
            run = self._plan_cache.get(key)
            if run is None:
                plan_cache["misses"] += 1
                with spans.span(spans.PLAN_BUILD):
                    run = self._build_fn(g, regions, input_objs, param_vals,
                                         dev)
                self._plan_cache[key] = run
            else:
                plan_cache["hits"] += 1
        return run, chosen, inp_arrays, presets, regions

    def _build_fn(self, g: _Graph, regions, input_objs, param_vals, dev):
        """-> run(input tensors, memo presets, groups, traced) -> per
        output, a tuple of tensors. The bounds pass, the group plans and the
        run's steps with each stage's last reader (`_steps`,
        `_last_readers`) are made on the first run and kept (the planned
        graph, `run.planned`);
        with `groups` False every group is evaluated whole-array. `traced`
        maps id(Param) to a 0-d tensor that takes the Param's place in the
        evaluation (derivative.propagate_adjoints: the bounds and the
        plans still see its value)."""
        planned: dict = {}
        # the inputs' mins as they are bound now (the cache key holds them)
        in_mins = [(t, buf._mins) for (t, buf) in input_objs]

        def run(inp_arrays, presets=None, groups=True, traced=None):
            from .ops import group_kernel
            presets = presets or {}
            realizations: Dict[int, Realized] = {}
            for (t, mins), arr in zip(in_mins, inp_arrays):
                realizations[id(t)] = Realized(
                    (arr,), mins, getattr(t, "name", "buf"))
            for fid, (mins, arrs) in presets.items():
                realizations[fid] = Realized(arrs, mins, "memo")
            first = "boxes" not in planned
            if first:
                with spans.span(spans.BOUNDS):
                    planned["boxes"] = self._bounds(g, regions, realizations,
                                                    param_vals)
                planned["groups"] = {}
                planned["stages"] = {}
            boxes = planned["boxes"]
            trace = self.trace
            ctx0 = Ctx(0, {}, {}, realizations,
                       {**param_vals, **(traced or {})}, dev, trace=trace,
                       stages=planned["stages"])
            cliques = _fusion_cliques(g)
            if first:
                planned["steps"] = _steps(g, boxes, cliques)
                planned["release"] = _last_readers(
                    planned["steps"], g, _kept_roots(g, self.outputs,
                                                     presets))
                if dev.type == "cuda":
                    _prepare_stages(g, boxes, ctx0, presets, cliques,
                                    groups)

            def record(fn, b, arrays):
                fs = fn._fschedule
                if trace is not None and (fs.trace_stores
                                          or fs.trace_realizations
                                          or fs.trace_loads):
                    trace.record_realization(fn, b, arrays)

            def eval_standalone(fn):
                if id(fn) in presets:
                    return      # memoized: fetched from the cache
                b = boxes.get(id(fn))
                if b is not None and b.defined():
                    with spans.span(spans.STAGE, fn.name):
                        realizations[id(fn)] = _evaluate_func(fn, b, ctx0)
                        record(fn, b, realizations[id(fn)].arrays)

            live: Dict[int, int] = {}       # stage id -> its arrays' bytes
            peak = 0
            for (kind, f, members), drop in zip(planned["steps"],
                                                planned["release"]):
                if kind != "stage":     # a compute_with clique, the tail
                    for m in members:
                        eval_standalone(m)
                else:
                    real = None
                    if groups and group_kernel.find_tile(f) is not None:
                        real = group_kernel.try_group(
                            f, boxes[id(f)], ctx0, g, planned["groups"])
                    if real is not None:
                        realizations[id(f)] = real
                        _emit_debug_dump(f, real.arrays)
                        # the group's output is traced as any realization
                        # is; its members live in the kernel's shared
                        # memory and are not
                        record(f, boxes[id(f)], real.arrays)
                    else:
                        for m in members:
                            eval_standalone(m)
                        eval_standalone(f)
                for m in members + ([f] if kind == "stage" else []):
                    real = realizations.get(id(m))
                    if real is not None and id(m) not in presets:
                        live[id(m)] = sum(a.nbytes for a in real.arrays)
                peak = max(peak, sum(live.values()))
                # root lifetimes: each stage's arrays go after their last
                # reader's step
                for fid in drop:
                    if realizations.pop(fid, None) is not None:
                        roots["released"] += 1
                    live.pop(fid, None)
            roots["peak_bytes"] = peak
            outs = []
            for f in self.outputs:
                req, box = regions[id(f)], boxes[id(f)]
                idx = tuple(
                    slice(req.dims[i].lo - box.dims[i].lo,
                          req.dims[i].lo - box.dims[i].lo
                          + req.dims[i].extent())
                    for i in reversed(range(f.dimensions())))
                outs.append(tuple(a[idx] for a in realizations[id(f)].arrays))
            return tuple(outs)

        run.planned = planned
        # for plan_graph: the graph gathered, and by `groups` flag the CUDA
        # graph captured, or why the plan stays eager
        run.func_graph = g
        run.replays = {}
        return run

    def _bounds(self, g, regions, realizations, param_vals):
        bp = _BoundsPass(g, BoundsEngine(
            resolver=_resolver(realizations, param_vals)))
        bp.run(self.outputs, {k: Box(list(v.dims))
                              for k, v in regions.items()})
        for t in g.inputs.values():
            box = bp.boxes.get(id(t))
            if box is None or not box.defined():
                continue
            real = realizations[id(t)]
            nd = real.arrays[0].ndim
            for i in range(t.dimensions()):
                iv = box.dims[i]
                lo = real.mins[i]
                hi = lo + real.arrays[0].shape[nd - 1 - i] - 1
                if iv.lo < lo or iv.hi > hi:
                    raise CompileError(
                        f"input {getattr(t, 'name', '?')} is accessed at "
                        f"dim {i} over {iv}, but its bounds are "
                        f"[{lo}, {hi}]; add a boundary condition "
                        "(e.g. repeat_edge) or clamp")
        return bp.boxes

    # -- memoize -----------------------------------------------------------
    def _memo_precompute(self, g: _Graph, input_objs, param_vals, regions,
                         dev) -> dict:
        """{id(f): (mins, tensors on dev)} of the memoized stages (not the
        outputs): each looked up in the native LRU cache by a hash of its
        sub-pipeline's schedule, box, params and inputs (their bytes up to
        8 MB each, read back from the card), and realized by its own
        sub-pipeline and stored on a miss. `last_memo` keeps the hashing
        time and the hits and misses."""
        memo_funcs = [f for f in g.funcs
                      if id(f) in g.materialized
                      and f._fschedule.memoized
                      and f not in self.outputs]
        if not memo_funcs:
            return {}
        from .runtime import memo_cache
        lookup = {id(t): buf for (t, buf) in input_objs}
        realz = {id(t): Realized((buf.data,), buf._mins)
                 for (t, buf) in input_objs}
        bp = _BoundsPass(g, BoundsEngine(
            resolver=_resolver(realz, param_vals)))
        bp.run(self.outputs, {k: Box(list(v.dims))
                              for k, v in regions.items()})
        cache = memo_cache()
        presets = {}
        rec = {"key_s": 0.0, "hits": [], "misses": []}
        for f in memo_funcs:
            box = bp.boxes.get(id(f))
            if box is None or not box.bounded():
                continue
            t0 = time.perf_counter()
            sub = Pipeline(f)
            sub_g = gather_graph([f])
            h = hashlib.sha1()
            h.update(repr(self._signature(sub_g)).encode())
            h.update(repr((box.mins(), box.extents())).encode())
            h.update(repr(sorted(
                (p.name, repr(param_vals.get(id(p))))
                for p in sub_g.params.values())).encode())
            for t in sub_g.inputs.values():
                buf = lookup.get(id(t))
                if buf is None:
                    continue
                a = buf.data
                h.update(str(tuple(a.shape)).encode())
                h.update(str(a.dtype).encode())
                if a.numel() * a.element_size() <= (8 << 20):
                    h.update(_bytes(a))
                else:
                    h.update(str(id(buf)).encode())
            key = h.digest()
            rec["key_s"] += time.perf_counter() - t0
            types = f.output_types()
            shape = tuple(reversed(box.extents()))
            hit = cache.lookup(key)
            if hit is not None:
                arrs, off = [], 0
                for t in types:
                    dt = torch_dtype(t)
                    n = int(np.prod(shape)) * torch.empty(
                        0, dtype=dt).element_size()
                    arrs.append(torch.frombuffer(
                        bytearray(hit[off:off + n]), dtype=dt).reshape(
                            shape).to(dev))
                    off += n
                presets[id(f)] = (box.mins(), arrs)
                rec["hits"].append(f.name)
                continue
            dsts = [Buffer(type=t, sizes=box.extents(), mins=box.mins())
                    for t in types]
            sub.realize(dst=dsts if len(dsts) > 1 else dsts[0], device=dev)
            arrs = [d.data.contiguous() for d in dsts]
            cache.store(key, b"".join(_bytes(a) for a in arrs))
            presets[id(f)] = (box.mins(), arrs)
            rec["misses"].append(f.name)
        last_memo.clear()
        last_memo.update(rec)
        return presets

    def _package(self, arrays, regions, dst):
        results = []
        for f, arrs in zip(self.outputs, arrays):
            req = regions[id(f)]
            bufs = [Buffer(a, mins=req.mins(), name=f.name) for a in arrs]
            results.append(bufs[0] if len(bufs) == 1 else Realization(bufs))
        if dst is not None:
            flat = []
            for r in results:
                flat.extend(r if isinstance(r, Realization) else [r])
            dsts = dst if isinstance(dst, (list, tuple)) else [dst]
            for d, s in zip(dsts, flat):
                d._data = s.data
            return dst
        if len(results) == 1:
            return results[0]
        return Realization(results)

    # -- AOT-style compiled callable ---------------------------------------
    def compile_to_callable(self, arguments=None, target=None):
        """Returns fn(*buffers_or_arrays, sizes=[...], device=None) ->
        Buffer(s): binds the arguments in order and realizes. The analog of
        Pipeline::compile_to_callable (reference: src/Callable.h:82)."""
        pipeline = self

        class Callable:
            def __init__(self):
                self.arguments = arguments

            def __call__(self, *args, sizes=None, device=None):
                if arguments:
                    for spec, val in zip(arguments, args):
                        if isinstance(spec, ImageParam):
                            spec.set(val if isinstance(val, Buffer)
                                     else Buffer(val))
                        elif isinstance(spec, Param):
                            spec.set(val)
                return pipeline.realize(sizes, target=target, device=device)

        return Callable()

    def compile_jit(self, target=None):
        return self

    def infer_input_bounds(self, sizes, target=None, device=None):
        """Allocate and bind zero-filled buffers, on `device` (None: the
        card), for the unbound ImageParams, sized to the required regions
        (reference: Pipeline.cpp:1126-1240)."""
        dev = resolve_device(device)
        g = gather_graph(self.outputs)
        regions = self._out_regions(sizes)
        unbound = [t for t in g.inputs.values()
                   if isinstance(t, ImageParam) and t._bound is None]
        param_vals = {}
        for p in g.params.values():
            try:
                param_vals[id(p)] = p.get()
            except CompileError:
                if p._estimate is not None:
                    param_vals[id(p)] = p._estimate
                else:
                    raise

        def resolver(name, args):
            if name == "param":
                return param_vals.get(id(args[0]))
            obj, i = args[0], args[1]
            if isinstance(obj, ImageParam) and obj._bound is not None:
                b = obj._bound
                if name == "buffer_min":
                    return b.dim(i).min
                return b.dim(i).extent
            if isinstance(obj, ImageParam) and i in obj.estimates:
                mn, ex = obj.estimates[i]
                return static_int(mn if name == "buffer_min" else ex,
                                  Ctx(0, {}, {}, {}, {}))
            return None

        bp = _BoundsPass(g, BoundsEngine(resolver=resolver))
        bp.run(self.outputs, regions)
        for t in unbound:
            box = bp.boxes.get(id(t))
            if box is None or not box.bounded():
                raise CompileError(f"cannot infer bounds for {t.name}")
            t.set(Buffer(torch.zeros(tuple(reversed(box.extents())),
                                     dtype=torch_dtype(t.type), device=dev),
                         mins=box.mins(), name=t.name))
        return [t.get() for t in unbound]

    # -- profile -----------------------------------------------------------
    def profile(self, sizes=None, dst=None, mode="stages", device=None):
        """Per-stage time/memory report on `device` (None: the card).

        mode="stages": each materialized Func evaluated alone, whole-array
        (no group kernel; on the card, by its stage kernel where that takes
        it, all built first), once to warm up and once timed: attributable,
        but unfused.
        mode="fused": prefix differencing -- the pipeline truncated after
        each materialized stage, realized exactly as realize() runs it
        (stencil groups through their kernel), timed in steady state;
        consecutive differences attribute per-stage cost in the real
        program (the analog of the reference's sampling profiler,
        runtime/profiler_common.cpp:151).
        On the card each time is taken with CUDA events on the current
        stream (waiting on the stop event, not on the device); on the CPU
        with the host clock. (reference: src/Profiling.cpp;
        HL_PROFILER_JSON_OUTPUT-style dict + formatted __str__)."""
        dev = resolve_device(device)
        g = gather_graph(self.outputs)
        regions = self._out_regions(sizes, dst)
        input_objs = self._inputs(g)
        param_vals = {id(p): p.get() for p in g.params.values()}
        realizations: Dict[int, Realized] = {
            id(t): Realized((buf.data.to(dev),), buf._mins,
                            getattr(t, "name", "buf"))
            for (t, buf) in input_objs}
        boxes = self._bounds(g, regions, realizations, param_vals)
        if mode == "fused":
            return self._profile_fused(g, boxes, sizes, dst, dev)
        ctx0 = Ctx(0, {}, {}, realizations, param_vals, dev, stages={})
        stored = [(f, boxes[id(f)]) for f in g.funcs
                  if id(f) in g.materialized and boxes.get(id(f)) is not None
                  and boxes[id(f)].defined()]
        if dev.type == "cuda":               # the stage kernels, one build
            from .ops import stage_kernel
            stage_kernel.prepare(ctx0, stage_kernel.regions_of(
                realizations, stored), [(f, b, None) for f, b in stored])
        entries = []
        total = 0.0
        for f, box in stored:
            _evaluate_func(f, box, ctx0)           # warm-up
            got = []
            ms = _time_ms(lambda: got.append(_evaluate_func(f, box, ctx0)),
                          dev)
            real = realizations[id(f)] = got[0]
            nbytes = sum(a.numel() * a.element_size() for a in real.arrays)
            if not f._fschedule.no_profiling:
                entries.append({"name": f.name, "ms": ms, "bytes": nbytes,
                                "box": list(zip(box.mins(), box.extents()))})
            total += ms
        return _StagesReport(total_ms=total, funcs=entries)

    def _profile_fused(self, g, boxes, sizes, dst, dev, reps: int = 3):
        from . import plan_graph

        def steady_ms(p, p_sizes=None, p_dst=None):
            # plan and build, then capture the plan's graph on the card
            for _ in range(plan_graph._CAPTURE_HIT + 1):
                p.realize(p_sizes, dst=p_dst, device=dev)
            return _time_ms(lambda: [p.realize(p_sizes, dst=p_dst,
                                               device=dev)
                                     for _ in range(reps)], dev) / reps

        out_ids = {id(f) for f in self.outputs}
        entries = []
        prev = 0.0
        for f in g.funcs:
            is_out = id(f) in out_ids
            if id(f) not in g.materialized and not is_out:
                continue
            box = boxes.get(id(f))
            if box is None or not box.defined():
                continue
            if is_out:
                cum = steady_ms(self, sizes, dst)
            else:
                db = Buffer(type=f.output_type(0), sizes=box.extents(),
                            mins=box.mins(), name=f.name)
                try:
                    cum = steady_ms(Pipeline(f), None, db)
                except Exception:
                    continue   # unprofilable prefix (e.g. tuple dst)
            entries.append({"name": f.name, "ms": max(0.0, cum - prev),
                            "cum_ms": cum,
                            "box": list(zip(box.mins(), box.extents()))})
            prev = cum
        return _FusedReport(total_ms=prev, funcs=entries)

    def apply_autoscheduler(self, target=None, params=None):
        """Schedule the pipeline with a registered autoscheduler
        (`params["name"]`, Mullapudi2016 by default; autoschedule.py)."""
        from .autoschedule import apply_autoscheduler
        return apply_autoscheduler(self, target, params)

    def get_func(self, i):
        g = gather_graph(self.outputs)
        return g.funcs[i]

    def print_loop_nest(self):
        from .loopnest import print_loop_nest
        print_loop_nest(self.outputs[0])


class _StagesReport(dict):
    def __str__(self):
        lines = [f"total (stage-at-a-time): {self['total_ms']:.3f} ms"]
        for e2 in sorted(self["funcs"], key=lambda d: -d["ms"]):
            pct = 100 * e2["ms"] / max(self["total_ms"], 1e-9)
            lines.append(
                f"  {e2['name']:28s} {e2['ms']:9.3f}ms "
                f"({pct:5.1f}%)  {e2['bytes'] / 1e6:8.2f} MB")
        return "\n".join(lines)


class _FusedReport(dict):
    def __str__(self):
        lines = [f"total (fused): {self['total_ms']:.3f} ms "
                 f"(per-stage = prefix deltas)"]
        for e2 in sorted(self["funcs"], key=lambda d: -d["ms"]):
            pct = 100 * e2["ms"] / max(self["total_ms"], 1e-9)
            lines.append(f"  {e2['name']:28s} {e2['ms']:9.3f}ms "
                         f"({pct:5.1f}%)  cum {e2['cum_ms']:9.3f}ms")
        return "\n".join(lines)


def _time_ms(fn, dev) -> float:
    """Milliseconds fn() takes: CUDA events on the current stream of a
    card (synchronizing on the stop event), the host clock on the CPU."""
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(stream)
        fn()
        b.record(stream)
        b.synchronize()
        return a.elapsed_time(b)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _resolver(realizations, param_vals):
    """The bounds engine's resolver of params and input dims."""
    def resolver(name, args):
        if name == "param":
            return param_vals.get(id(args[0]))
        real = realizations.get(id(args[0]))
        if real is None:
            return None
        if name == "buffer_min":
            return real.mins[args[1]]
        if name == "buffer_extent":
            a = real.arrays[0]
            return a.shape[a.ndim - 1 - args[1]]
        return None
    return resolver


def _bytes(a: torch.Tensor) -> bytes:
    """A tensor's storage bytes in its own dtype (read back from the
    card)."""
    return a.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()


def _owned(arrays, ctx0: Ctx) -> List[torch.Tensor]:
    """The tensors an update may write in place: contiguous, and copied
    where one aliases an input, another Func's realization or another value
    of the same Func (all copied while a program is exported: a traced
    tensor has no storage to compare)."""
    from .ops.export_ops import exporting
    if exporting():
        return [a.clone(memory_format=torch.contiguous_format)
                for a in arrays]
    taken = {a.untyped_storage().data_ptr()
             for real in ctx0.realizations.values() for a in real.arrays}
    out = []
    for a in arrays:
        a = a.contiguous()
        ptr = a.untyped_storage().data_ptr()
        if ptr in taken:
            a = a.clone()
            ptr = a.untyped_storage().data_ptr()
        taken.add(ptr)
        out.append(a)
    return out


def _evaluate_extern(f: Func, box: Box, ctx0: Ctx) -> Realized:
    """Run the extern stage's host callback (the JAX package's
    jax.pure_callback): numpy in, numpy out, on the host. Each input is
    cropped to the region its footprint asked for (reference: the extern
    receives halide_buffer_ts cropped to the bounds query) and copied off
    the realize's device; the result is copied back onto it, in the
    declared type. `last_extern` keeps the round trip's times and bytes."""
    meta = f._extern
    t0 = time.perf_counter()
    in_arrays = []
    for src, b2 in zip(meta["inputs"], _extern_boxes(f, box)):
        real = ctx0.realizations.get(id(src))
        if real is None:
            raise CompileError(
                f"extern stage {f.name}: input "
                f"{getattr(src, 'name', src)} not realized")
        arr = real.arrays[0]
        idx = []
        for i in reversed(range(len(b2.dims))):
            off = int(b2.dims[i].lo) - int(real.mins[i])
            ext = int(b2.dims[i].extent())
            if off < 0 or off + ext > arr.shape[len(idx)]:
                raise CompileError(
                    f"extern stage {f.name}: queried region of "
                    f"{getattr(src, 'name', src)} exceeds its realization")
            idx.append(slice(off, off + ext))
        in_arrays.append(to_numpy(arr[tuple(idx)]))
    t1 = time.perf_counter()
    result = np.asarray(meta["callback"](*in_arrays))
    t2 = time.perf_counter()
    out_shape = tuple(reversed(box.extents()))
    if tuple(result.shape) != out_shape:
        raise CompileError(
            f"extern stage {f.name}: callback returned shape "
            f"{tuple(result.shape)}, expected {out_shape}")
    out = torch.from_numpy(np.ascontiguousarray(result)).to(
        ctx0.device).to(torch_dtype(meta["type"]))
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)
    last_extern.clear()
    last_extern.update(
        func=f.name, copy_out_s=t1 - t0, callback_s=t2 - t1,
        copy_in_s=time.perf_counter() - t2,
        bytes_out=sum(a.nbytes for a in in_arrays), bytes_in=result.nbytes)
    return Realized((out,), box.mins(), f.name)


def _debug_dump_cb(fname: str, a: np.ndarray) -> None:
    """debug_to_file writer (reference: src/DebugToFile.cpp), byte for byte
    the JAX package's. `.npy` gets the numpy format; otherwise a 5-int32
    header (four extents minor-first, padded with 1s, then a type code per
    HalideRuntime's debug_to_file table) followed by the raw data."""
    if fname.endswith(".npy"):
        np.save(fname, a)
        return
    codes = {"float32": 0, "float64": 1, "uint8": 2, "int8": 3,
             "uint16": 4, "int16": 5, "uint32": 6, "int32": 7,
             "uint64": 8, "int64": 9}
    ext = list(reversed(a.shape)) + [1] * max(0, 4 - a.ndim)
    hdr = np.asarray(ext[:4] + [codes.get(a.dtype.name, 0)], np.int32)
    with open(fname, "wb") as fh:
        hdr.tofile(fh)
        a.tofile(fh)


def _emit_debug_dump(f: Func, arrays) -> None:
    """Dump each value of f's realization where its schedule asks for it
    (a copy off the card; bfloat16, which numpy lacks, as float32)."""
    fname = f._fschedule.debug_file
    if not fname:
        return
    for i, arr in enumerate(arrays):
        out = fname if len(arrays) == 1 else f"{fname}.{i}"
        _debug_dump_cb(out, to_numpy(arr))


def last_realize(pipeline, device=None):
    """What `pipeline`'s last realize ran, made ready to run again on
    `device` (the tests and tools that hold a kernel against its plain
    version): -> (the device, its plan's planned graph, the Func graph,
    the realizations of its inputs on the device, the Params' values by
    id, [(Func, box)] of every stored stage in the order it ran them). A
    realize keeps none of its tensors for this."""
    dev = resolve_device(device)
    planned = list(pipeline._plan_cache.values())[-1].planned
    g = gather_graph(pipeline.outputs)
    realz: Dict[int, Realized] = {}
    for t in g.inputs.values():
        buf = t if isinstance(t, Buffer) else t.get()
        realz[id(t)] = Realized((buf.data.to(dev),), buf._mins, buf.name)
    params = {id(p): p.get() for p in g.params.values()}
    stored = []
    for f in g.funcs:
        box = planned["boxes"].get(id(f))
        if id(f) in g.materialized and box is not None and box.defined():
            stored.append((f, box))
    return dev, planned, g, realz, params, stored


def _prepare_stages(g: _Graph, boxes, ctx0: Ctx, presets, cliques,
                    groups: bool) -> None:
    """Plan the stage kernels of a plan's whole-array stages on its first
    run, and build them together (ops/stage_kernel.prepare): every
    materialized Func the run evaluates alone, reading the arrays the run
    realizes (each over its box). A Func the group kernel may take (a
    tiled one) or a member of its group is planned only where the run
    evaluates it alone."""
    from .ops import group_kernel, stage_kernel
    stored, todo = [], []
    for f in g.funcs:
        box = boxes.get(id(f))
        if id(f) not in g.materialized or box is None or not box.defined():
            continue
        stored.append((f, box))
        lvl = f._fschedule.compute_level
        if id(f) in presets or (
                lvl.kind == "at" and id(lvl.func) in g.materialized) or (
                groups and group_kernel.find_tile(f) is not None):
            continue
        todo.append((f, box, "a compute_with clique member"
                     if id(f) in cliques else None))
    stage_kernel.prepare(ctx0, stage_kernel.regions_of(
        ctx0.realizations,
        [(f, b) for f, b in stored if id(f) not in ctx0.realizations]),
        todo)


def _evaluate_func(f: Func, box: Box, ctx0: Ctx) -> Realized:
    """Whole-array evaluation of a Func over `box`, its update definitions
    applied in order, stored in the storage dtype of each value's Type
    (and dumped where its schedule asks: debug_to_file). On the card, a
    stage of one pure definition and one value is one emitted kernel where
    the stage kernel takes it (ops/stage_kernel)."""
    from .ops import stage_kernel
    real = stage_kernel.compute(f, box, ctx0)
    if real is not None:             # one emitted kernel, on the card
        return real
    if f.is_extern():
        return _evaluate_extern(f, box, ctx0)
    from .updates import apply_update
    axes = {v.name: Axis(v.name, i, int(box.dims[i].lo),
                         int(box.dims[i].extent()))
            for i, v in enumerate(f._args)}
    ctx = Ctx(f.dimensions(), axes, {}, ctx0.realizations, ctx0.params,
              ctx0.device, trace=ctx0.trace)
    shape = full_shape(ctx, list(axes.values()))
    types = [v.dtype for v in f._defs[0].values]
    updates = f._defs[1:]
    arrays = []
    for v, t in zip(f._defs[0].values, types):
        # while updates run, values stay in the compute dtype
        dt = compute_dtype(t) if updates else torch_dtype(t)
        if isinstance(v, E.Intrin) and v.name == "undef":
            # undef(): storage left uninitialized in the reference; zeros
            # keep determinism
            arrays.append(torch.zeros(shape, dtype=dt, device=ctx.device))
            continue
        arrays.append(eval_array(v, ctx).expand(shape).to(dt).contiguous())
    if not updates:
        _emit_debug_dump(f, arrays)
        return Realized(arrays, box.mins(), f.name)
    # updates write their Func's tensors in place where they can (the scan
    # kernel writes its span directly): first make sure nothing else holds
    # them
    current = _owned(arrays, ctx0)
    for d in updates:
        ctx_u = Ctx(f.dimensions(), axes, {}, dict(ctx0.realizations),
                    ctx0.params, ctx0.device, trace=ctx0.trace)
        ctx_u.realizations[id(f)] = Realized(current, box.mins(), f.name)
        current = _owned(apply_update(f, d, current, ctx_u), ctx0)
    arrays = [a.to(torch_dtype(t)) for a, t in zip(current, types)]
    _emit_debug_dump(f, arrays)
    return Realized(arrays, box.mins(), f.name)

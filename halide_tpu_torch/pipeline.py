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
   (ops/group_kernel), one launch for the group
5. cache the planned graph (bounds and group plans) per graph, sizes and
   bound inputs, so a repeated realize only executes

Everything runs on the realize device: the card unless the caller asks for
the CPU. Where there is no card and none was asked for, realize raises.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import expr as E
from .bounds import BoundsEngine, Box, Interval
from .buffer import Buffer, ImageParam, Param, Realization
from .eval_torch import Axis, Ctx, Realized, eval_array, full_shape, static_int
from .expr import CompileError, Expr
from .func import Func
from .htypes import compute_dtype, torch_dtype
from .visitors import walk

__all__ = ["Pipeline", "resolve_device"]


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


def gather_graph(outputs: List[Func]) -> _Graph:
    g = _Graph()
    seen: Dict[int, Func] = {}
    order: List[Func] = []
    visiting: set = set()

    def want_materialize(f: Func) -> bool:
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
                or f._fschedule.memoized
                or any(d.schedule.fused_with for d in f._defs))

    def visit(f: Func):
        if id(f) in seen:
            return
        if id(f) in visiting:
            raise CompileError(f"cyclic func graph at {f.name}")
        if f.is_extern():
            raise NotImplementedError(
                f"extern stage {f.name}: extern stages come in slice 3 of "
                "the port")
        if not f.defined():
            raise CompileError(f"Func {f.name} is used before it is defined")
        visiting.add(id(f))
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
    for f in order:
        if f in outputs or want_materialize(f):
            g.materialized[id(f)] = f
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
                        and id(of) in g.materialized:
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

    def realize(self, sizes=None, target=None, dst=None, device=None):
        """Realize the outputs over `sizes` (or over `dst`'s region) on
        `device`: None means the card, and raises where there is none.
        `target` is checked but selects nothing in this slice."""
        from .target import Target
        if isinstance(target, str):
            Target(target)
        dev = resolve_device(device)
        g = gather_graph(self.outputs)
        regions = self._out_regions(sizes, dst)
        input_objs = []
        for t in g.inputs.values():
            if isinstance(t, ImageParam):
                buf = t.get()
            elif isinstance(t, Buffer):
                buf = t
            else:
                raise CompileError(f"unbound input {t!r}")
            input_objs.append((t, buf))
        param_vals = {id(p): p.get() for p in g.params.values()}
        key = (self._signature(g), str(dev),
               tuple((b.mins(), b.extents()) for b in regions.values()),
               tuple((tuple(buf.data.shape), buf.data.dtype, buf._mins)
                     for (_, buf) in input_objs),
               tuple(sorted((k, repr(v)) for k, v in param_vals.items())))
        run = self._plan_cache.get(key)
        if run is None:
            run = self._build_fn(g, regions, input_objs, param_vals, dev)
            self._plan_cache[key] = run
        arrays = run([buf.data.to(dev) for (_, buf) in input_objs])
        return self._package(arrays, regions, dst)

    def _build_fn(self, g: _Graph, regions, input_objs, param_vals, dev):
        """-> run(input tensors) -> per output, a tuple of tensors. The
        bounds pass and the group plans are made on the first run and kept
        (the planned graph, `run.planned`)."""
        planned: dict = {}

        def run(inp_arrays):
            from .ops import group_kernel
            realizations: Dict[int, Realized] = {}
            for (t, buf), arr in zip(input_objs, inp_arrays):
                realizations[id(t)] = Realized(
                    (arr,), buf._mins, getattr(t, "name", "buf"))
            if "boxes" not in planned:
                planned["boxes"] = self._bounds(g, regions, realizations,
                                                param_vals)
                planned["groups"] = {}
            boxes = planned["boxes"]
            ctx0 = Ctx(0, {}, {}, realizations, param_vals, dev)

            def eval_standalone(fn):
                b = boxes.get(id(fn))
                if b is not None and b.defined():
                    realizations[id(fn)] = _evaluate_func(fn, b, ctx0)

            cliques = _fusion_cliques(g)
            deferred: Dict[int, List[Func]] = {}
            for f in g.funcs:
                if id(f) not in g.materialized:
                    continue
                box = boxes.get(id(f))
                if box is None or not box.defined():
                    continue
                lvl = f._fschedule.compute_level
                if lvl.kind == "at" and id(lvl.func) in g.materialized:
                    deferred.setdefault(id(lvl.func), []).append(f)
                    continue
                clique = cliques.get(id(f))
                if clique is not None:
                    if f is clique[-1]:   # lowered together when the last
                        for m in clique:
                            eval_standalone(m)
                    continue
                members = deferred.pop(id(f), [])
                real = None
                if group_kernel.find_tile(f) is not None:
                    real = group_kernel.try_group(
                        f, box, ctx0, g, planned["groups"])
                if real is not None:
                    realizations[id(f)] = real
                else:
                    for m in members:
                        eval_standalone(m)
                    eval_standalone(f)
            # any remaining deferred members (anchor unprocessed) run alone
            for ms in deferred.values():
                for m in ms:
                    eval_standalone(m)
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
        return run

    def _bounds(self, g, regions, realizations, param_vals):
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

        bp = _BoundsPass(g, BoundsEngine(resolver=resolver))
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

    def compile_jit(self, target=None):
        return self

    def compile_to_callable(self, arguments=None, target=None):
        raise NotImplementedError("compile_to_callable comes in slice 3 of "
                                  "the port")

    def infer_input_bounds(self, sizes, target=None):
        raise NotImplementedError("infer_input_bounds comes in slice 3 of "
                                  "the port")


def _owned(arrays, ctx0: Ctx) -> List[torch.Tensor]:
    """The tensors an update may write in place: contiguous, and copied
    where one aliases an input, another Func's realization or another value
    of the same Func."""
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


def _evaluate_func(f: Func, box: Box, ctx0: Ctx) -> Realized:
    """Whole-array evaluation of a Func over `box`, its update definitions
    applied in order, stored in the storage dtype of each value's Type."""
    from .updates import apply_update
    axes = {v.name: Axis(v.name, i, int(box.dims[i].lo),
                         int(box.dims[i].extent()))
            for i, v in enumerate(f._args)}
    ctx = Ctx(f.dimensions(), axes, {}, ctx0.realizations, ctx0.params,
              ctx0.device)
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
        return Realized(arrays, box.mins(), f.name)
    # updates write their Func's tensors in place where they can (the scan
    # kernel writes its span directly): first make sure nothing else holds
    # them
    current = _owned(arrays, ctx0)
    for d in updates:
        ctx_u = Ctx(f.dimensions(), axes, {}, dict(ctx0.realizations),
                    ctx0.params, ctx0.device)
        ctx_u.realizations[id(f)] = Realized(current, box.mins(), f.name)
        current = _owned(apply_update(f, d, current, ctx_u), ctx0)
    return Realized([a.to(torch_dtype(t)) for a, t in zip(current, types)],
                    box.mins(), f.name)

"""The algorithm front-end: Var, Func, Stage, definitions.

The analog of the reference's Func/Var/Function/Definition machinery
(reference: src/Func.h:753, src/Var.h:19, src/Function.h:39,121, src/Definition.h:38).
A Func is a pure definition `f[x, y] = expr` plus optional update definitions;
scheduling directives attach a Schedule that the lowering consumes.
"""
from __future__ import annotations

import copy
from typing import Any, List, Optional, Sequence, Tuple

from . import expr as E
from .expr import Call, CompileError, Expr, to_expr
from .htypes import Int, Type
from .rdom import RDom, RVar, collect_rdom
from .schedule import (Bound, Dim, ForType, FuncSchedule, LoopLevel, Split,
                       StageSchedule, StorageDim, TailStrategy)
from .visitors import expr_uses_var, find_variables, walk

__all__ = ["Var", "Func", "Stage", "FuncRef", "_"]

# The definition epoch, one count for the process: every change to what
# `pipeline.gather_graph` walks bumps it -- a Func's definitions, its extern
# stage or its specializations, a held Definition's args, values, predicates
# or RDom, an RDom's predicates (`RDom.where`) or an RVar's bounds. A
# Pipeline reuses its last walk while the epoch stands (`Pipeline._prepare`).
# Schedule directives leave it: the walk does not read them.
_epoch = [0]


def definition_epoch() -> int:
    return _epoch[0]


def definitions_changed() -> None:
    _epoch[0] += 1


class Var(E.Variable):
    """A pure loop variable (reference: src/Var.h:19)."""
    __slots__ = ()

    _counter = [0]

    def __init__(self, name: Optional[str] = None):
        if name is None:
            Var._counter[0] += 1
            name = f"v{Var._counter[0]}"
        super().__init__(name, Int(32))

    @staticmethod
    def implicit(i: int) -> "Var":
        return Var(f"_{i}")

    def same_as(self, other) -> bool:
        return isinstance(other, E.Variable) and other.name == self.name


class _Implicit:
    """The `_` placeholder that pads argument lists
    (reference: src/Var.h Var::implicit, src/Func.h:1276-1283)."""

    def __repr__(self):
        return "_"


_ = _Implicit()


def _resolve_implicit(target, args: Sequence) -> Tuple:
    """Expand `_` placeholders to implicit vars to pad to target's arity."""
    args = tuple(args)
    n_placeholders = sum(1 for a in args if isinstance(a, _Implicit))
    if n_placeholders == 0:
        return args
    if n_placeholders > 1:
        raise CompileError("at most one `_` placeholder per call")
    dims = target.dimensions()
    missing = dims - (len(args) - 1)
    out: List = []
    for a in args:
        if isinstance(a, _Implicit):
            out.extend(Var.implicit(i) for i in range(missing))
        else:
            out.append(a)
    return tuple(out)


class Definition:
    """One pure or update definition (reference: src/Definition.h:38).
    Setting a walked field again (`Func.in_` redirecting its consumers,
    `rfactor`) bumps the definition epoch; setting it the first time does
    not, since no Func holds the Definition yet."""

    _WALKED = frozenset(("args", "values", "rdom", "predicates"))

    def __init__(self, args: Tuple[Expr, ...], values: Tuple[Expr, ...],
                 rdom: Optional[RDom], predicates: List[Expr],
                 pure_args: Tuple[str, ...]):
        self.args = args
        self.values = values
        self.rdom = rdom
        self.predicates = predicates
        rvar_names = [rv.name for rv in rdom.dims] if rdom is not None else []
        # loop vars: the pure vars that actually appear, then rvars
        self.schedule = StageSchedule(list(pure_args), rvar_names)

    def __setattr__(self, name, value):
        if name in Definition._WALKED and name in self.__dict__:
            _epoch[0] += 1
        object.__setattr__(self, name, value)

    def replaced(self, **fields) -> "Definition":
        """A copy with `fields` replaced, which no Func holds: the epoch
        stays."""
        d = copy.copy(self)
        d.__dict__.update(fields)
        return d

    def is_pure(self) -> bool:
        return self.rdom is None and all(
            isinstance(a, Var) for a in self.args)


class FuncRef:
    """f[x, y] — usable as an Expr and as an assignment target."""

    def __init__(self, func: "Func", args: Tuple):
        self.func = func
        self.args = args

    def _to_expr(self) -> Expr:
        return self._index(0)

    def _index(self, i: int) -> Expr:
        f = self.func
        if not f.defined():
            raise CompileError(f"Func {f.name} is used before it is defined")
        args = tuple(to_expr(a) for a in _resolve_implicit(f, self.args))
        if len(args) != f.dimensions():
            raise CompileError(
                f"{f.name} has {f.dimensions()} dims, called with {len(args)}")
        return Call(f, args, i)

    def __getitem__(self, i: int) -> Expr:
        if not isinstance(i, int):
            raise CompileError("FuncRef tuple index must be an int")
        return self._index(i)

    # ---- in-place update sugar ------------------------------------------
    def _rmw(self, other, op: str, identity):
        f = self.func
        if not f.defined():
            # implicit initialization (reference: src/Func.cpp FuncRef::operator+=)
            pure = tuple(a for a in self.args if isinstance(a, Var))
            if len(pure) != len(self.args):
                raise CompileError(
                    f"cannot implicitly initialize {f.name}: update indices are "
                    "not all pure vars; define an initial value first")
            rhs = to_expr(other)
            f[pure] = E.const(identity, rhs.dtype)
        cur = self._to_expr()
        return E.make_binary(op, cur, other)

    def __iadd__(self, other):
        return self._rmw(other, "add", 0)

    def __isub__(self, other):
        return self._rmw(other, "sub", 0)

    def __imul__(self, other):
        return self._rmw(other, "mul", 1)

    def __itruediv__(self, other):
        return self._rmw(other, "div", 1)

    def __repr__(self):
        return repr(self._to_expr())


def _ref_op(name, rev=False):
    def op(self, *a):
        return getattr(self._to_expr(), name)(*a)
    op.__name__ = name
    return op


for _n in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
           "__truediv__", "__rtruediv__", "__floordiv__", "__rfloordiv__",
           "__mod__", "__rmod__", "__pow__", "__rpow__", "__neg__", "__pos__",
           "__abs__", "__lshift__", "__rshift__", "__and__", "__rand__",
           "__or__", "__ror__", "__xor__", "__rxor__", "__invert__",
           "__eq__", "__ne__", "__lt__", "__le__", "__gt__", "__ge__"):
    setattr(FuncRef, _n, _ref_op(_n))
FuncRef.__hash__ = object.__hash__


class Stage:
    """Schedule handle for one definition (reference: src/Func.h Stage)."""

    def __init__(self, func: "Func", index: int):
        self.func = func
        self.index = index

    @property
    def _sched(self) -> StageSchedule:
        return self.func._defs[self.index].schedule

    def _vn(self, v) -> str:
        return v.name if isinstance(v, E.Variable) else str(v)

    # ---- loop restructuring ---------------------------------------------
    def split(self, old, outer, inner, factor,
              tail: TailStrategy = TailStrategy.Auto) -> "Stage":
        s = self._sched
        oldn = self._vn(old)
        i = s.find_dim(oldn)
        is_r = s.dims[i].is_rvar
        s.dims[i:i + 1] = [Dim(self._vn(inner), s.dims[i].for_type, is_r),
                           Dim(self._vn(outer), s.dims[i].for_type, is_r)]
        s.splits.append(Split(oldn, self._vn(outer), self._vn(inner),
                              factor, "split", tail))
        return self

    def fuse(self, a, b, fused) -> "Stage":
        s = self._sched
        ia, ib = s.find_dim(self._vn(a)), s.find_dim(self._vn(b))
        is_r = s.dims[ia].is_rvar or s.dims[ib].is_rvar
        keep = min(ia, ib)
        drop = max(ia, ib)
        del s.dims[drop]
        s.dims[keep] = Dim(self._vn(fused), s.dims[keep].for_type, is_r)
        s.splits.append(Split(self._vn(a), self._vn(b), self._vn(fused),
                              None, "fuse"))
        return self

    def rename(self, old, new) -> "Stage":
        s = self._sched
        i = s.find_dim(self._vn(old))
        s.dims[i] = Dim(self._vn(new), s.dims[i].for_type, s.dims[i].is_rvar)
        s.splits.append(Split(self._vn(old), self._vn(new), self._vn(new),
                              None, "rename"))
        return self

    def reorder(self, *vars) -> "Stage":
        """reorder(innermost, ..., outermost): the named loops are permuted
        among their own positions (reference: src/Func.h reorder)."""
        s = self._sched
        names = [self._vn(v) for v in vars]
        idxs = sorted(s.find_dim(n) for n in names)
        dims_by_name = {s.dims[s.find_dim(n)].var: s.dims[s.find_dim(n)]
                        for n in names}
        for pos, n in zip(idxs, names):
            s.dims[pos] = dims_by_name[n]
        return self

    def tile(self, *args, **kw) -> "Stage":
        """tile(x, y, xo, yo, xi, yi, tx, ty) or tile(x, y, xi, yi, tx, ty)
        (reference: src/Func.h tile)."""
        tail = kw.pop("tail", TailStrategy.Auto)
        if len(args) == 8:
            x, y, xo, yo, xi, yi, tx, ty = args
        elif len(args) == 6:
            x, y, xi, yi, tx, ty = args
            xo, yo = x, y
        else:
            raise CompileError("tile takes 6 or 8 variables + factors")
        self.split(x, xo, xi, tx, tail)
        self.split(y, yo, yi, ty, tail)
        self.reorder(xi, yi, xo, yo)
        return self

    # ---- loop type marks --------------------------------------------------
    def _mark(self, var, ft: ForType, factor=None,
              tail: TailStrategy = TailStrategy.Auto) -> "Stage":
        name = self._vn(var)
        if factor is not None:
            # split with factor keeps the original name on the outer loop
            # (reference: src/Func.cpp Stage::vectorize/unroll/parallel)
            inner = Var(f"{name}i$")
            self.split(var, var, inner, factor, tail)
            if ft in (ForType.VECTORIZED, ForType.UNROLLED,
                      ForType.GPU_THREAD):
                tgt = inner.name
            else:
                tgt = name
        else:
            tgt = name
        s = self._sched
        di = s.find_dim(tgt)
        if (ft == ForType.PARALLEL and s.dims[di].is_rvar
                and self.index > 0):
            self._check_parallel_rvar()
        s.dims[di].for_type = ft
        return self

    def _check_parallel_rvar(self):
        """Parallelizing an RVar requires a proof (reference:
        src/ParallelRVar.cpp + Associativity.cpp): the update must be
        atomic(), allow_race_conditions(), or a provably associative
        combine."""
        s = self._sched
        if s.atomic or s.allow_races:
            return
        from .updates import _decompose_combine
        d = self.func._defs[self.index]
        for i, v in enumerate(d.values):
            if _decompose_combine(v, self.func, d.args, i) is None:
                raise CompileError(
                    f"{self.func.name}: cannot parallelize an RVar of a "
                    "non-associative update; use atomic(), rfactor(), or "
                    "allow_race_conditions()")

    def vectorize(self, var, factor=None, tail=TailStrategy.Auto) -> "Stage":
        return self._mark(var, ForType.VECTORIZED, factor, tail)

    def unroll(self, var, factor=None, tail=TailStrategy.Auto) -> "Stage":
        return self._mark(var, ForType.UNROLLED, factor, tail)

    def parallel(self, var, factor=None, tail=TailStrategy.Auto) -> "Stage":
        return self._mark(var, ForType.PARALLEL, factor, tail)

    def serial(self, var) -> "Stage":
        return self._mark(var, ForType.SERIAL)

    # ---- reductions -------------------------------------------------------
    def atomic(self, override_associativity_test: bool = False) -> "Stage":
        self._sched.atomic = True
        return self

    def allow_race_conditions(self) -> "Stage":
        self._sched.allow_races = True
        return self

    def rfactor(self, *args):
        from .rfactor import rfactor_impl
        if len(args) == 1 and isinstance(args[0], (list, tuple)):
            pairs = args[0]
        elif len(args) == 2:
            pairs = [(args[0], args[1])]
        else:
            raise CompileError("rfactor(rvar, var) or rfactor([(rvar, var)...])")
        return rfactor_impl(self.func, self.index, pairs)

    def compute_with(self, other, var, align=None) -> "Stage":
        """Fuse this stage's loop nest with a sibling's from `var` outward
        (reference: src/Func.h compute_with, src/Schedule.h:538 FusedPair).
        `align` accepts a LoopAlignStrategy, or a dict/list mapping loop-var
        names to strategies (reference: src/Schedule.h:139-152). All
        alignment variants are value-identical here -- see
        LoopAlignStrategy's docstring -- but the strategy is validated,
        recorded, serialized, and shown in the stmt report."""
        from .schedule import LoopAlignStrategy

        def _norm_one(a):
            if a is None:
                return LoopAlignStrategy.Auto
            if isinstance(a, LoopAlignStrategy):
                return a
            if isinstance(a, str):
                try:
                    return LoopAlignStrategy[a]
                except KeyError:
                    pass
            raise CompileError(
                f"compute_with: invalid align {a!r}; expected a "
                "LoopAlignStrategy (Auto/AlignStart/AlignEnd/NoAlign)")

        vn = self._vn(var)
        if isinstance(align, dict):
            amap = {(self._vn(k)): _norm_one(v) for k, v in align.items()}
        elif isinstance(align, (list, tuple)):
            amap = {self._vn(k): _norm_one(v) for (k, v) in align}
        else:
            amap = {vn: _norm_one(align)}
        for k in amap:
            if not self._sched.has_dim(k):
                raise CompileError(
                    f"compute_with align: no loop variable named {k!r} in "
                    f"{self.func.name}")
        other_stage = other if isinstance(other, Stage) else Stage(other, 0)
        self._sched.fused_with.append(
            ((other_stage.func, other_stage.index), vn, amap))
        return self

    # ---- misc -------------------------------------------------------------
    def prefetch(self, *a, **kw) -> "Stage":
        """(reference: src/PrefetchDirective.h) Recorded like
        async()/ring_buffer(): the group kernel's plan reports the request
        (`async_requested`); K1 has one window buffer, staged by cp.async
        before its sub-tile computes, and prefetches nothing."""
        self.func._fschedule.is_async = True
        return self

    def specialize(self, cond):
        from .specialize import add_specialization
        return add_specialization(self.func, self.index, cond)

    def specialize_fail(self, msg: str):
        from .specialize import add_specialize_fail
        add_specialize_fail(self.func, self.index, msg)

    # GPU directives accepted for ported schedules; mapped to grid concepts.
    def gpu_blocks(self, *vars, **kw) -> "Stage":
        for v in vars:
            self._mark(v, ForType.GPU_BLOCK)
        return self

    def gpu_threads(self, *vars, **kw) -> "Stage":
        for v in vars:
            self._mark(v, ForType.GPU_THREAD)
        return self

    def gpu_lanes(self, var, **kw) -> "Stage":
        return self._mark(var, ForType.GPU_THREAD)

    def gpu_single_thread(self, **kw) -> "Stage":
        return self

    def gpu_tile(self, *args, **kw) -> "Stage":
        """gpu_tile(x, y, xi, yi, tx, ty) and friends -> tile + marks."""
        tail = kw.pop("tail", TailStrategy.Auto)
        if len(args) == 3:
            x, xi, tx = args
            outer = Var(f"{self._vn(x)}o")
            self.split(x, outer, xi, tx, tail)
            self._mark(outer, ForType.GPU_BLOCK)
            self._mark(xi, ForType.GPU_THREAD)
            return self
        if len(args) == 6:
            x, y, xi, yi, tx, ty = args
            self.tile(x, y, xi, yi, tx, ty, tail=tail)
            self._mark(x, ForType.GPU_BLOCK)
            self._mark(y, ForType.GPU_BLOCK)
            self._mark(xi, ForType.GPU_THREAD)
            self._mark(yi, ForType.GPU_THREAD)
            return self
        if len(args) == 8:
            x, y, xo, yo, xi, yi, tx, ty = args
            self.tile(x, y, xo, yo, xi, yi, tx, ty, tail=tail)
            self._mark(xo, ForType.GPU_BLOCK)
            self._mark(yo, ForType.GPU_BLOCK)
            self._mark(xi, ForType.GPU_THREAD)
            self._mark(yi, ForType.GPU_THREAD)
            return self
        raise CompileError("unsupported gpu_tile arity")

    def hexagon(self, *a, **kw) -> "Stage":
        return self

    def unscheduled(self) -> "Stage":
        return self

    def never_partition_all(self) -> "Stage":
        return self

    def partition(self, *a, **kw) -> "Stage":
        return self

    def dump_argument_list(self) -> str:
        return ", ".join(d.var for d in self._sched.dims)


class Func:
    """A pipeline stage (reference: src/Func.h:753)."""

    _counter = [0]

    def __init__(self, name_or_expr=None, name: Optional[str] = None):
        if isinstance(name_or_expr, str):
            name = name_or_expr
            name_or_expr = None
        if name is None:
            Func._counter[0] += 1
            name = f"f{Func._counter[0]}"
        self.name = name
        self._defs: List[Definition] = []
        self._fschedule = FuncSchedule()
        self._args: Tuple[Var, ...] = ()
        self._required_types: Optional[List[Type]] = None
        self._required_dims: Optional[int] = None
        self._specializations: List = []   # managed by specialize.py
        self._extern = None
        if name_or_expr is not None:
            # Func(expr): 0-arg lambda unless the expr uses implicit vars
            e = to_expr(name_or_expr)
            ivars = sorted({v.name for v in find_variables(e)
                            if v.name.startswith("_") and v.name[1:].isdigit()})
            vs = tuple(Var(n) for n in ivars)
            self[vs] = e

    # ---- definition -----------------------------------------------------
    def __setitem__(self, keys, value) -> None:
        if not isinstance(keys, tuple):
            keys = (keys,)
        if isinstance(value, FuncRef):
            value = value._to_expr()
        if isinstance(value, (tuple, list)) or isinstance(value, TupleExpr):
            vals = tuple(to_expr(v) for v in value)
        else:
            vals = (to_expr(value),)
        if not self._defs:
            self._define_pure(keys, vals)
        else:
            self._define_update(keys, vals)

    def _define_pure(self, keys, vals) -> None:
        for k in keys:
            if not isinstance(k, Var):
                raise CompileError(
                    f"{self.name}: the pure definition's arguments must be "
                    f"distinct Vars, got {k!r}")
        names = [k.name for k in keys]
        if len(set(names)) != len(names):
            raise CompileError(f"{self.name}: duplicate pure vars {names}")
        rd = collect_rdom(vals)
        if rd is not None:
            # a pure definition may reference an RDom only inside a Reduce;
            # bare RVars make it an implicit update (sum() handles this), so
            # reject to match the reference's error.
            bare = _has_bare_rvar(vals)
            if bare:
                raise CompileError(
                    f"{self.name}: pure definition cannot use RDom var "
                    f"{bare} directly; use hl.sum()/update defs")
        if self._required_dims is not None and len(keys) != self._required_dims:
            raise CompileError(
                f"{self.name}: expected {self._required_dims} dims")
        self._args = tuple(keys)
        d = Definition(tuple(keys), vals, None, [], tuple(names))
        self._defs.append(d)
        definitions_changed()

    def _define_update(self, keys, vals) -> None:
        if len(keys) != len(self._args):
            raise CompileError(
                f"{self.name}: update has {len(keys)} args, pure def has "
                f"{len(self._args)}")
        keys = tuple(to_expr(k) for k in keys)
        all_exprs = list(keys) + list(vals)
        rd = collect_rdom(all_exprs)
        preds = list(rd.predicates) if rd is not None else []
        # pure vars referenced in the update must appear bare at their own
        # position in the LHS (reference: src/Function.cpp define_update checks)
        used = set()
        for e in all_exprs:
            for v in find_variables(e):
                used.add(v.name)
        pure_in_update = []
        for i, a in enumerate(self._args):
            if a.name in used:
                k = keys[i]
                if not (isinstance(k, E.Variable) and k.name == a.name):
                    raise CompileError(
                        f"{self.name}: update uses pure var {a.name} but LHS "
                        f"position {i} is {k!r}; pure vars must appear "
                        "unadorned at their own position")
                pure_in_update.append(a.name)
        ptypes = [v.dtype for v in self._defs[0].values]
        if len(vals) != len(ptypes):
            raise CompileError(
                f"{self.name}: update defines {len(vals)} values, pure def "
                f"has {len(ptypes)}")
        vals = tuple(
            v if v.dtype == t else E.Cast(t, v)
            for v, t in zip(vals, ptypes))
        d = Definition(keys, vals, rd, preds, tuple(pure_in_update))
        self._defs.append(d)
        definitions_changed()

    def __getitem__(self, keys) -> FuncRef:
        if not isinstance(keys, tuple):
            keys = (keys,)
        return FuncRef(self, keys)

    def __call__(self, *args) -> FuncRef:
        return FuncRef(self, args)

    # ---- introspection ---------------------------------------------------
    def defined(self) -> bool:
        return bool(self._defs) or self.is_extern()

    def dimensions(self) -> int:
        if not self.defined():
            raise CompileError(f"Func {self.name} is undefined")
        return len(self._args)

    def args(self) -> Tuple[Var, ...]:
        return self._args

    def outputs(self) -> int:
        return len(self._defs[0].values) if self.defined() else 0

    def output_type(self, value_index: int = 0) -> Type:
        if self.is_extern():
            return self._extern["type"]
        if not self.defined():
            raise CompileError(f"Func {self.name} is used before it is defined")
        return self._defs[0].values[value_index].dtype

    def output_types(self) -> List[Type]:
        return [v.dtype for v in self._defs[0].values]

    def value(self) -> Expr:
        return self._defs[0].values[0]

    def values(self):
        return self._defs[0].values

    def has_update_definition(self) -> bool:
        return len(self._defs) > 1

    def num_update_definitions(self) -> int:
        return len(self._defs) - 1

    def update(self, i: int = 0) -> Stage:
        if i + 1 >= len(self._defs):
            raise CompileError(f"{self.name} has no update {i}")
        return Stage(self, i + 1)

    def update_args(self, i: int = 0):
        return self._defs[i + 1].args

    def update_value(self, i: int = 0) -> Expr:
        return self._defs[i + 1].values[0]

    def update_values(self, i: int = 0):
        return self._defs[i + 1].values

    def in_(self, consumers=None) -> "Func":
        """Wrapper func (reference: src/Func.h:1404-1464). Global form only:
        creates g with g(vars) = f(vars) and redirects all existing consumers."""
        from .wrappers import make_wrapper
        return make_wrapper(self, consumers)

    def clone_in(self, consumers) -> "Func":
        from .wrappers import make_wrapper
        return make_wrapper(self, consumers, clone=True)

    def copy_to_device(self, *a, **kw) -> "Func":
        return self

    def copy_to_host(self, *a, **kw) -> "Func":
        return self

    # ---- func-level schedule --------------------------------------------
    def compute_root(self) -> "Func":
        self._fschedule.compute_level = LoopLevel.root()
        return self

    def compute_inline(self) -> "Func":
        self._fschedule.compute_level = LoopLevel.inlined()
        return self

    def compute_at(self, f, var=None) -> "Func":
        if isinstance(f, LoopLevel):
            self._fschedule.compute_level = f
        else:
            self._fschedule.compute_level = LoopLevel(f, var)
        return self

    def store_root(self) -> "Func":
        self._fschedule.store_level = LoopLevel.root()
        return self

    def store_at(self, f, var=None) -> "Func":
        if isinstance(f, LoopLevel):
            self._fschedule.store_level = f
        else:
            self._fschedule.store_level = LoopLevel(f, var)
        return self

    def store_in(self, memory_type) -> "Func":
        self._fschedule.tags.append(f"store_in:{memory_type}")
        return self

    def hoist_storage(self, f=None, var=None) -> "Func":
        return self

    def hoist_storage_root(self) -> "Func":
        return self

    def fold_storage(self, var, factor) -> "Func":
        self._fschedule.storage_dims.append(
            StorageDim(var.name if isinstance(var, E.Variable) else str(var),
                       int(factor)))
        return self

    def ring_buffer(self, extent: int) -> "Func":
        self._fschedule.ring_buffer_extent = int(extent)
        return self

    def async_(self) -> "Func":
        self._fschedule.is_async = True
        return self

    def memoize(self, eviction_key=None) -> "Func":
        self._fschedule.memoized = True
        self._fschedule.memoize_eviction_key = eviction_key
        return self

    def compute_with(self, other, var, align=None) -> "Func":
        Stage(self, 0).compute_with(other, var, align)
        return self

    def bound(self, var, mn, extent) -> "Func":
        self._fschedule.bounds.append(
            Bound(var.name, to_expr(mn), to_expr(extent)))
        return self

    def bound_extent(self, var, extent) -> "Func":
        self._fschedule.bounds.append(Bound(var.name, None, to_expr(extent)))
        return self

    def align_bounds(self, var, modulus, remainder=0) -> "Func":
        self._fschedule.bounds.append(
            Bound(var.name, None, None, to_expr(modulus), to_expr(remainder)))
        return self

    def align_extent(self, var, modulus) -> "Func":
        return self

    def align_storage(self, var, alignment) -> "Func":
        return self

    def reorder_storage(self, *vars) -> "Func":
        return self

    def set_estimate(self, var, mn, extent) -> "Func":
        self._fschedule.estimates.append(
            Bound(var.name, to_expr(mn), to_expr(extent)))
        return self

    def set_estimates(self, ranges) -> "Func":
        for v, (mn, ex) in zip(self._args, ranges):
            self.set_estimate(v, mn, ex)
        return self

    # ---- multi-chip -------------------------------------------------------
    def distribute(self, var, axis_name: str = "devices") -> "Func":
        """Shard this (output) Func's `var` across the mesh axis
        `axis_name`. `realize(..., mesh=m)` then splits a pure dimension
        into one slab a shard, each with its halo rows from its neighbours
        (global edges repeated), or a reduction var into one slice of the
        RDom a shard, whose partials are combined in shard order
        (parallel/distribute.py). Without a mesh the directive is
        ignored."""
        name = var.name if hasattr(var, "name") else str(var)
        is_pure = any(v.name == name for v in self._args)
        is_rvar = any(
            d.rdom is not None and any(rv.name == name for rv in d.rdom.dims)
            for d in self._defs[1:])
        if not (is_pure or is_rvar):
            raise CompileError(
                f"distribute: {self.name} has no pure dim or reduction "
                f"var {name!r}")
        self._fschedule.distributed = (name, axis_name)
        return self

    # ---- observability ----------------------------------------------------
    def trace_loads(self) -> "Func":
        self._fschedule.trace_loads = True
        return self

    def trace_stores(self) -> "Func":
        self._fschedule.trace_stores = True
        return self

    def trace_realizations(self) -> "Func":
        self._fschedule.trace_realizations = True
        return self

    def add_trace_tag(self, tag: str) -> "Func":
        self._fschedule.tags.append(tag)
        return self

    def no_profiling(self) -> "Func":
        self._fschedule.no_profiling = True
        return self

    def debug_to_file(self, filename: str) -> "Func":
        """Dump this Func's realization to `filename` each time it is
        produced (reference: src/DebugToFile.cpp, Lower.cpp:257).
        `.npy` writes the numpy format; anything else writes the
        reference's .tmp debug layout (5 int32 header: four extents,
        minor-first, then a type code -- HalideRuntime debug_to_file)."""
        self._fschedule.debug_file = filename
        self._fschedule.tags.append(f"debug_to_file:{filename}")
        return self

    def print_loop_nest(self) -> None:
        from .loopnest import print_loop_nest
        print_loop_nest(self)

    # ---- stage-0 delegation -----------------------------------------------
    def __getattr__(self, item):
        # delegate scheduling directives to the pure stage
        if item.startswith("_"):
            raise AttributeError(item)
        stage_attr = getattr(Stage, item, None)
        if stage_attr is not None:

            def bound_method(*a, **kw):
                r = stage_attr(Stage(self, 0), *a, **kw)
                return self if isinstance(r, Stage) else r

            return bound_method
        raise AttributeError(f"Func has no attribute {item!r}")

    def define_extern(self, name, callback, input_sources=None,
                      output_type=None, dimensions=None, footprint=None,
                      bounds_query=None):
        """Define this Func as an extern stage (reference:
        src/Function.h:247 define_extern + the bounds-query protocol,
        BoundsInference.cpp:452-506). `callback(*input_np_arrays) ->
        np_array` runs on the host: each cropped input is copied off the
        realize's device to numpy, and the result is copied back onto it;
        `footprint(output_box) -> [input_boxes]` is the analog of the
        null-host bounds query (defaults to passing the output box
        through); `bounds_query(output_box) -> Box` lets the stage ROUND UP
        the region it will actually produce (e.g. alignment) -- the
        reference's DOUBLE query: outputs are re-queried first, then the
        inputs are sized from the rounded-up output."""
        from .htypes import Float
        if self._defs:
            raise CompileError(f"{self.name} is already defined")
        self.name = name or self.name
        self._extern = {
            "callback": callback,
            "inputs": list(input_sources or []),
            "type": output_type or Float(32),
            "dims": int(dimensions if dimensions is not None else 2),
            "footprint": footprint,
            "bounds_query": bounds_query,
        }
        self._args = tuple(Var(f"_e{i}") for i in range(self._extern["dims"]))
        definitions_changed()
        return self

    def is_extern(self) -> bool:
        return getattr(self, "_extern", None) is not None

    # ---- execution --------------------------------------------------------
    def realize(self, sizes=None, target=None, **kw):
        """Pipeline(self).realize: `dst`, `jit`, `device`, `mesh`,
        `custom_print` and `custom_error` pass through by keyword."""
        from .pipeline import Pipeline
        return Pipeline(self).realize(sizes, target=target, **kw)

    def compile_to_callable(self, arguments=None, target=None):
        from .pipeline import Pipeline
        return Pipeline(self).compile_to_callable(arguments, target=target)

    def compile_jit(self, target=None):
        from .pipeline import Pipeline
        Pipeline(self).compile_jit(target)
        return self

    def infer_input_bounds(self, *a, **kw):
        from .pipeline import Pipeline
        return Pipeline(self).infer_input_bounds(*a, **kw)

    def __repr__(self):
        if self.is_extern():
            return f"Func({self.name}, extern)"
        if not self.defined():
            return f"Func({self.name}, undefined)"
        a = ", ".join(v.name for v in self._args)
        return f"Func({self.name}({a}) = {self._defs[0].values[0]!r})"


class TupleExpr(tuple):
    """An explicit Tuple of Exprs (reference: src/Tuple.h)."""

    def __new__(cls, *args):
        if len(args) == 1 and isinstance(args[0], (list, tuple)):
            args = tuple(args[0])
        return super().__new__(cls, tuple(to_expr(a) for a in args))


def _has_bare_rvar(vals) -> Optional[str]:
    """An RVar used outside of any Reduce node."""
    found: List[str] = []

    def scan(e, inside_reduce):
        if isinstance(e, RVar) and not inside_reduce:
            found.append(e.name)
            return
        if isinstance(e, E.Reduce):
            for c in e.children():
                scan(c, True)
            return
        for c in e.children():
            scan(c, inside_reduce)

    for v in vals:
        scan(v, False)
    return found[0] if found else None

"""Interval arithmetic and required-region inference.

The analog of the reference's bounds machinery (reference: src/Interval.h,
src/Bounds.cpp:3358 `bounds_of_expr_in_scope`, src/BoundsInference.cpp). Because
schedules are restricted to affine splits, intervals stay closed-form: every
bound here evaluates to a concrete number at plan time (realize sizes are
known before anything runs), so there is no symbolic simplifier — the 6,600-LoC rewrite
system in the reference collapses into plain Python min/max arithmetic.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

from . import expr as E
from .expr import CompileError, Expr

NEG_INF = -math.inf
POS_INF = math.inf


class Interval:
    __slots__ = ("lo", "hi")

    def __init__(self, lo, hi):
        self.lo = lo
        self.hi = hi

    @staticmethod
    def everything() -> "Interval":
        return Interval(NEG_INF, POS_INF)

    @staticmethod
    def point(v) -> "Interval":
        return Interval(v, v)

    def is_bounded(self) -> bool:
        return self.lo != NEG_INF and self.hi != POS_INF

    def union(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    def intersect(self, other: "Interval") -> "Interval":
        return Interval(max(self.lo, other.lo), min(self.hi, other.hi))

    def extent(self):
        return self.hi - self.lo + 1

    def __repr__(self):
        return f"[{self.lo}, {self.hi}]"

    def __eq__(self, o):
        return isinstance(o, Interval) and self.lo == o.lo and self.hi == o.hi

    def __hash__(self):
        return hash((self.lo, self.hi))


def _mul(a: Interval, b: Interval) -> Interval:
    cands = []
    for x in (a.lo, a.hi):
        for y in (b.lo, b.hi):
            if (x in (NEG_INF, POS_INF)) and y == 0:
                cands.append(0)
            elif (y in (NEG_INF, POS_INF)) and x == 0:
                cands.append(0)
            else:
                cands.append(x * y)
    return Interval(min(cands), max(cands))


def _floordiv(x, y):
    if x in (NEG_INF, POS_INF) or y in (NEG_INF, POS_INF):
        s = (1 if x > 0 else -1) * (1 if y > 0 else -1)
        return POS_INF * s if x in (NEG_INF, POS_INF) else 0
    if isinstance(x, float) or isinstance(y, float):
        return x / y
    return x // y


def _div(a: Interval, b: Interval, is_float: bool) -> Interval:
    cands = []
    # reference semantics: x/0 == 0 for ints (src/IROperator.h div_imp)
    if b.lo <= 0 <= b.hi and not is_float:
        cands.append(0)
    denoms = set()
    for y in (b.lo, b.hi):
        if y != 0:
            denoms.add(y)
    # if the divisor interval crosses +-1, extremes occur near there
    for y in (1, -1):
        if b.lo <= y <= b.hi:
            denoms.add(y)
    if not denoms:
        return Interval.point(0)
    for x in (a.lo, a.hi):
        for y in denoms:
            if is_float:
                if y == 0:
                    continue
                cands.append(x / y)
            else:
                cands.append(_floordiv(x, y))
    if not cands:
        return Interval.everything()
    return Interval(min(cands), max(cands))


def _mod(a: Interval, b: Interval) -> Interval:
    # result sign follows divisor (reference: src/IROperator.h mod semantics)
    if not (b.lo != NEG_INF and b.hi != POS_INF):
        return Interval.everything()
    m = max(abs(b.lo), abs(b.hi))
    if m == 0:
        return Interval.point(0)
    if b.lo >= 0:
        out = Interval(0, m - 1)
    elif b.hi <= 0:
        out = Interval(-(m - 1), 0)
    else:
        out = Interval(-(m - 1), m - 1)
    # a fully inside [0, b) stays exact
    if a.lo != NEG_INF and a.hi != POS_INF and b.lo > 0 and \
            0 <= a.lo and a.hi < b.lo:
        return a
    return out


_MONOTONIC_INCR = {"sqrt", "exp", "log", "floor", "ceil", "round", "trunc",
                   "tanh", "atan", "asinh", "erf", "sinh"}


class BoundsEngine:
    """bounds_of_expr_in_scope with pluggable resolution of params/buffers and
    producer value bounds."""

    def __init__(self, resolver: Optional[Callable] = None,
                 call_bounds: Optional[Callable] = None):
        # resolver(intrin_name, args) -> concrete int (param / buffer_min / …)
        self.resolver = resolver
        # call_bounds(call_expr, scope) -> Interval or None
        self.call_bounds = call_bounds

    def bounds(self, e: Expr, scope: Dict[str, Interval]) -> Interval:
        b = self._bounds(e, scope)
        return b

    def _bounds(self, e: Expr, scope: Dict[str, Interval]) -> Interval:
        if isinstance(e, E.IntImm):
            return Interval.point(e.value)
        if isinstance(e, E.FloatImm):
            return Interval.point(e.value)
        if isinstance(e, E.Variable):
            iv = scope.get(e.name)
            if iv is not None:
                return iv
            return Interval.everything()
        if isinstance(e, E.Cast):
            inner = self._bounds(e.value, scope)
            t = e.dtype
            if t.is_integer() and not t.is_bool():
                lo, hi = inner.lo, inner.hi
                if e.value.dtype.is_float():
                    # float->int casts truncate toward zero
                    lo = math.trunc(lo) if lo not in (NEG_INF, POS_INF) else lo
                    hi = math.trunc(hi) if hi not in (NEG_INF, POS_INF) else hi
                r = Interval(lo, hi)
                trange = Interval(t.min_value(), t.max_value())
                if r.lo >= trange.lo and r.hi <= trange.hi:
                    return r
                # may wrap: all we know is the type range
                return trange
            return inner
        if isinstance(e, E.Binary):
            if e.op in ("and", "or") or e.op in E._COMPARISONS:
                return Interval(0, 1)
            a = self._bounds(e.a, scope)
            b = self._bounds(e.b, scope)
            if e.op == "add":
                return Interval(a.lo + b.lo, a.hi + b.hi)
            if e.op == "sub":
                return Interval(a.lo - b.hi, a.hi - b.lo)
            if e.op == "mul":
                return _mul(a, b)
            if e.op == "div":
                return _div(a, b, e.dtype.is_float())
            if e.op == "mod":
                return _mod(a, b)
            if e.op == "min":
                return Interval(min(a.lo, b.lo), min(a.hi, b.hi))
            if e.op == "max":
                return Interval(max(a.lo, b.lo), max(a.hi, b.hi))
            if e.op == "shl" and b.is_bounded() and b.lo >= 0:
                return _mul(a, Interval(2 ** b.lo, 2 ** b.hi))
            if e.op == "shr" and b.is_bounded() and b.lo >= 0:
                return _div(a, Interval(2 ** b.lo, 2 ** b.hi), False)
            if e.op in ("bitor", "bitxor", "bitand") and a.is_bounded() \
                    and b.is_bounded() and a.lo >= 0 and b.lo >= 0:
                # nonnegative bitwise ops stay below the next power of two
                if e.op == "bitand":
                    return Interval(0, min(a.hi, b.hi))
                hi = max(a.hi, b.hi)
                p = 1
                while p <= hi:
                    p <<= 1
                return Interval(0, p - 1)
            return self._type_range(e)
        if isinstance(e, E.Not):
            return Interval(0, 1)
        if isinstance(e, E.Select):
            t = self._bounds(e.true_value, scope)
            f = self._bounds(e.false_value, scope)
            return t.union(f)
        if isinstance(e, E.Let):
            v = self._bounds(e.value, scope)
            inner = dict(scope)
            inner[e.name] = v
            return self._bounds(e.body, inner)
        if isinstance(e, E.Call):
            if self.call_bounds is not None:
                r = self.call_bounds(e, scope)
                if r is not None:
                    return r
            return self._type_range(e)
        if isinstance(e, E.Intrin):
            return self._intrin_bounds(e, scope)
        if isinstance(e, E.Reduce):
            if e.op in ("argmin", "argmax") and e.value_index < len(e.rdom.dims):
                rv = e.rdom.dims[e.value_index]
                mn = self._bounds(rv.rmin, scope)
                ex = self._bounds(rv.rextent, scope)
                return Interval(mn.lo, mn.hi + ex.hi - 1)
            # value bounds of sum/... are data-dependent
            vb = self._bounds(e.value, self.rdom_scope(e.rdom, scope))
            if e.op in ("minimum", "maximum"):
                return vb
            return self._type_range(e)
        return self._type_range(e)

    def rdom_scope(self, rdom, scope: Dict[str, Interval]
                   ) -> Dict[str, Interval]:
        """`scope` with each of the RDom's RVars over its whole range."""
        inner = dict(scope)
        for rv in rdom.dims:
            mn = self._bounds(rv.rmin, scope)
            ex = self._bounds(rv.rextent, scope)
            inner[rv.name] = Interval(mn.lo, mn.hi + ex.hi - 1)
        return inner

    def _type_range(self, e: Expr) -> Interval:
        t = e.dtype
        # narrow integer loads/results have useful finite ranges (this is what
        # makes LUT/histogram index bounds closed-form)
        if t.is_integer() and t.bits <= 16:
            return Interval(t.min_value(), t.max_value())
        return Interval.everything()

    def _intrin_bounds(self, e: E.Intrin, scope) -> Interval:
        n = e.name
        if n in ("param", "buffer_min", "buffer_extent"):
            if self.resolver is not None:
                v = self.resolver(n, e.args)
                if v is not None:
                    return Interval.point(v)
            return Interval.everything()
        if n in ("likely", "strict_float"):
            return self._bounds(e.args[0], scope)
        if n == "require":
            return self._bounds(e.args[1], scope)
        if n in ("print", "print_when"):
            idx = 0 if n == "print" else 1
            return self._bounds(e.args[idx], scope)
        if n == "abs":
            a = self._bounds(e.args[0], scope)
            if a.lo >= 0:
                return a
            if a.hi <= 0:
                return Interval(-a.hi, -a.lo)
            return Interval(0, max(abs(a.lo), abs(a.hi)))
        if n == "absd":
            a = self._bounds(e.args[0], scope)
            b = self._bounds(e.args[1], scope)
            diff = Interval(a.lo - b.hi, a.hi - b.lo)
            if diff.lo >= 0:
                return diff
            if diff.hi <= 0:
                return Interval(-diff.hi, -diff.lo)
            return Interval(0, max(abs(diff.lo), abs(diff.hi)))
        if n in _MONOTONIC_INCR:
            a = self._bounds(e.args[0], scope)
            if a.is_bounded():
                f = getattr(math, n, None)
                if n == "round":
                    f = lambda x: float(round(x))
                if n == "trunc":
                    f = math.trunc
                if f is not None:
                    try:
                        return Interval(f(a.lo), f(a.hi))
                    except ValueError:
                        pass
            return Interval.everything()
        if n in ("sin", "cos"):
            return Interval(-1.0, 1.0)
        if n == "lerp":
            a = self._bounds(e.args[0], scope)
            b = self._bounds(e.args[1], scope)
            return a.union(b)
        if n == "saturating_cast":
            t = e.dtype
            inner = self._bounds(e.args[0], scope)
            return inner.intersect(Interval(t.min_value(), t.max_value()))
        if n == "random":
            if e.dtype.is_float():
                return Interval(0.0, 1.0)
            return self._type_range(e)
        return self._type_range(e)


def bounds_of_expr(e: Expr, scope: Dict[str, Interval],
                   resolver=None, call_bounds=None) -> Interval:
    return BoundsEngine(resolver, call_bounds).bounds(e, scope)


class Box:
    """Per-dimension required region of a func (reference: src/Bounds.h Box)."""

    def __init__(self, intervals):
        self.dims = list(intervals)

    @staticmethod
    def empty(n: int) -> "Box":
        return Box([None] * n)

    def union_dim(self, i: int, iv: Interval) -> None:
        self.dims[i] = iv if self.dims[i] is None else self.dims[i].union(iv)

    def union(self, other: "Box") -> None:
        for i, iv in enumerate(other.dims):
            if iv is not None:
                self.union_dim(i, iv)

    def mins(self):
        return tuple(int(d.lo) for d in self.dims)

    def extents(self):
        return tuple(int(d.hi - d.lo + 1) for d in self.dims)

    def defined(self) -> bool:
        return all(d is not None for d in self.dims)

    def bounded(self) -> bool:
        return self.defined() and all(d.is_bounded() for d in self.dims)

    def __repr__(self):
        return "Box(" + ", ".join(repr(d) for d in self.dims) + ")"

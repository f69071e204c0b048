"""Inline reductions: sum/product/maximum/minimum/argmin/argmax
(reference: src/InlineReductions.h:40-70). These build Reduce nodes that
eval_torch reduces over RDom axes added to the grid, and that the group
kernel K1 runs as loops over the RDom. (A copy of the JAX package's
inline_reductions.py, which builds expressions only.)"""
from __future__ import annotations

from typing import Optional

from . import expr as E
from .expr import CompileError, Expr, to_expr
from .htypes import Int
from .rdom import RDom, RVar, collect_rdom


def _norm_args(a, b):
    """Accept sum(e), sum(r, e), sum(e, name), sum(e, helper_func)."""
    rd = None
    helper = None
    if isinstance(a, RDom):
        rd = a
        e = to_expr(b)
    elif isinstance(a, RVar) and b is not None and not isinstance(b, str):
        rd = a.rdom
        e = to_expr(b)
    else:
        e = to_expr(a)
        from .func import Func
        if isinstance(b, Func):
            helper = b
    if rd is None:
        rd = collect_rdom([e])
        if rd is None:
            raise CompileError("inline reduction: expression uses no RDom")
    return rd, e, helper


def _helper_reduce(op_binop: str, identity, e, rd, helper):
    """sum(e, f) variant: define f(free_vars) = identity; f(...) op= e and
    return f(free_vars) — the helper is independently schedulable
    (reference: src/InlineReductions.cpp with an explicit Func)."""
    from .func import Var
    from .visitors import find_variables
    rnames = {rv.name for rv in rd.dims}
    frees = [v for v in find_variables(e)
             if v.name not in rnames and isinstance(v, E.Variable)
             and not isinstance(v, RVar)]
    # keep only genuine loop Vars (not params)
    vs = []
    seen = set()
    for v in frees:
        if v.name not in seen:
            seen.add(v.name)
            vs.append(Var(v.name))
    helper[tuple(vs)] = E.const(identity, e.dtype)
    cur = E.Call(helper, tuple(vs))
    helper.__setitem__(tuple(vs), E.make_binary(op_binop, cur, e))
    return E.Call(helper, tuple(vs))


def sum(a, b=None, name: Optional[str] = None) -> Expr:
    rd, e, helper = _norm_args(a, b)
    if helper is not None:
        return _helper_reduce("add", 0, e, rd, helper)
    return E.Reduce("sum", e, rd, None)


def product(a, b=None, name: Optional[str] = None) -> Expr:
    rd, e, helper = _norm_args(a, b)
    if helper is not None:
        return _helper_reduce("mul", 1, e, rd, helper)
    return E.Reduce("product", e, rd, None)


def maximum(a, b=None, name: Optional[str] = None) -> Expr:
    rd, e, helper = _norm_args(a, b)
    if helper is not None:
        return _helper_reduce("max", e.dtype.min_value(), e, rd, helper)
    return E.Reduce("maximum", e, rd, None)


def minimum(a, b=None, name: Optional[str] = None) -> Expr:
    rd, e, helper = _norm_args(a, b)
    if helper is not None:
        return _helper_reduce("min", e.dtype.max_value(), e, rd, helper)
    return E.Reduce("minimum", e, rd, None)


class _ArgTuple(tuple):
    """Result of argmin/argmax: coords + value, indexable like a Tuple."""


def argmax(a, b=None, name: Optional[str] = None):
    rd, e, _h = _norm_args(a, b)
    n = len(rd.dims)
    parts = [E.Reduce("argmax", e, rd, None, value_index=i,
                      dtype=Int(32) if i < n else e.dtype)
             for i in range(n + 1)]
    return _ArgTuple(parts)


def argmin(a, b=None, name: Optional[str] = None):
    rd, e, _h = _norm_args(a, b)
    n = len(rd.dims)
    parts = [E.Reduce("argmin", e, rd, None, value_index=i,
                      dtype=Int(32) if i < n else e.dtype)
             for i in range(n + 1)]
    return _ArgTuple(parts)

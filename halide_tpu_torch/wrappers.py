"""Func::in() wrappers (reference: src/Func.h:1404-1464, src/Func.cpp in_).

A wrapper g of f satisfies g(vars) = f(vars); consumers are redirected to call
g so that g can be scheduled independently (staging, compute_at granularity).
"""
from __future__ import annotations

from typing import Optional

from . import expr as E
from .expr import Call
from .func import Func, Var
from .visitors import mutate


def make_wrapper(f: Func, consumers=None, clone: bool = False) -> Func:
    g = Func(f"{f.name}_in" if not clone else f"{f.name}_clone")
    vs = tuple(Var(f"_w{i}") for i in range(f.dimensions()))
    g[vs] = Call(f, vs)

    if consumers is None:
        return g
    if isinstance(consumers, Func):
        consumers = [consumers]

    def redirect(n):
        if isinstance(n, E.Call) and n.target is f:
            return E.Call(g, n.args, n.value_index, n.dtype)
        return None

    for c in consumers:
        for d in c._defs:
            d.values = tuple(mutate(v, redirect) for v in d.values)
            d.args = tuple(
                mutate(a, redirect) if isinstance(a, E.Expr) else a
                for a in d.args)
            d.predicates = [mutate(p, redirect) for p in d.predicates]
    return g

"""rfactor: split an associative reduction into parallel partials
(reference: src/Func.h:120-145, legality proven by src/Associativity.cpp +
AssociativeOpsTable.cpp).

rfactor(rv, v) on an update lifts the (possibly split) reduction variable `rv`
into a pure dimension `v` of a new intermediate func that computes partial
reductions; the original update becomes a combine of the partials over the
lifted range. The intermediate's new pure axis is a real tensor axis, and
the final combine a reduction over it -- the analog of the reference's
"parallel partials + serial combine". (A copy of the JAX package's
rfactor.py: it builds Funcs and touches no array code.)

Split rvars are handled by reconstructing each original RDom dim as an affine
expression of the leaf rvars (outer*factor + inner + min) with round-up guard
predicates, matching ApplySplit.cpp semantics.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from . import expr as E
from .expr import CompileError, Expr, to_expr
from .func import Func, Var
from .rdom import RDom, RVar
from .visitors import mutate, substitute

_ASSOCIATIVE = {"add", "mul", "min", "max"}


def _leafify(d) -> Tuple[Dict[str, Expr], Dict[str, Tuple[Expr, Expr]],
                         List[Expr]]:
    """Apply the stage's splits to the rdom dims.

    Returns (repl, leaves, guards): repl maps each ORIGINAL rdom dim name to
    an Expr over leaf variable names; leaves maps leaf name -> (min, extent)
    Exprs; guards are predicates enforcing round-up tails."""
    repl: Dict[str, Expr] = {}
    leaves: Dict[str, Tuple[Expr, Expr]] = {}
    guards: List[Expr] = []
    for rv in d.rdom.dims:
        repl[rv.name] = E.Variable(rv.name)
        leaves[rv.name] = (rv.rmin, rv.rextent)
    for sp in d.schedule.splits:
        if sp.old not in leaves:
            continue
        if sp.kind == "rename":
            mn, ext = leaves.pop(sp.old)
            leaves[sp.inner] = (mn, ext)
            sub = {sp.old: E.Variable(sp.inner)}
        elif sp.kind == "split":
            mn, ext = leaves.pop(sp.old)
            f = to_expr(sp.factor)
            leaves[sp.inner] = (to_expr(0), f)
            leaves[sp.outer] = (to_expr(0), (ext + f - 1) / f)
            composed = E.Variable(sp.outer) * f + E.Variable(sp.inner) + mn
            sub = {sp.old: composed}
            exact = (isinstance(ext, E.IntImm) and isinstance(f, E.IntImm)
                     and f.value > 0 and ext.value % f.value == 0)
            if not exact:
                guards.append(
                    (E.Variable(sp.outer) * f + E.Variable(sp.inner)) < ext)
        else:
            raise CompileError(
                f"rfactor after '{sp.kind}' of rvars is not supported")
        for k in list(repl):
            repl[k] = substitute(repl[k], sub)
        guards = [substitute(g, sub) for g in guards]
    return repl, leaves, guards


def rfactor_impl(f: Func, def_index: int, pairs: List[Tuple]):
    from .updates import _decompose_combine, _identity_for

    d = f._defs[def_index]
    if d.rdom is None:
        raise CompileError(f"{f.name}: rfactor needs an update with an RDom")
    decomps = []
    for i, v in enumerate(d.values):
        dc = _decompose_combine(v, f, d.args, i)
        if dc is None or dc[0] not in _ASSOCIATIVE:
            raise CompileError(
                f"{f.name}: rfactor requires a provably associative update; "
                f"value {i} is not of the form f(...) op g")
        decomps.append(dc)

    repl, leaves, guards = _leafify(d)
    lifted: Dict[str, Var] = {}
    for rv, var in pairs:
        name = rv.name if isinstance(rv, (RVar, E.Variable)) else str(rv)
        if name not in leaves:
            raise CompileError(
                f"{f.name}: rfactor var {name!r} is not a reduction leaf; "
                f"have {sorted(leaves)}")
        lifted[name] = var if isinstance(var, Var) else Var(str(var))
    kept = [n for n in leaves if n not in lifted]

    inter = Func(f"{f.name}_intm")
    new_pure = [lifted[n] for n in lifted]
    pure_args = list(f._defs[0].args) + new_pure

    # new rdom over kept leaves
    sub_rdom = None
    leaf_sub: Dict[str, Expr] = {}
    if kept:
        sub_rdom = RDom([(leaves[n][0], leaves[n][1]) for n in kept],
                        name=f"{d.rdom.name}_kept")
        for n, nrv in zip(kept, sub_rdom.dims):
            leaf_sub[n] = nrv
    for n, v in lifted.items():
        leaf_sub[n] = v

    final_repl = {name: substitute(expr, leaf_sub)
                  for name, expr in repl.items()}
    final_repl.update({n: v for n, v in leaf_sub.items()
                       if n not in final_repl})

    def remap(e: Expr) -> Expr:
        def fn(n):
            if isinstance(n, E.Variable) and n.name in final_repl:
                r = final_repl[n.name]
                return None if (isinstance(r, E.Variable)
                                and r.name == n.name) else r
            if isinstance(n, E.Call) and n.target is f:
                return E.Call(inter, tuple(n.args) + tuple(new_pure),
                              n.value_index, n.dtype)
            return None
        return mutate(e, fn)

    inter[tuple(pure_args)] = tuple(
        E.const(_identity_for(op, v.dtype), v.dtype)
        for (op, _), v in zip(decomps, d.values)
    ) if len(d.values) > 1 else E.const(
        _identity_for(decomps[0][0], d.values[0].dtype), d.values[0].dtype)

    new_preds = [remap(p) for p in d.predicates] + [remap(g) for g in guards]
    if sub_rdom is not None:
        sub_rdom.predicates.extend(new_preds)
    lhs = tuple(remap(a) for a in d.args) + tuple(new_pure)
    new_vals = tuple(remap(v) for v in d.values)
    inter.__setitem__(lhs, new_vals if len(new_vals) > 1 else new_vals[0])
    if sub_rdom is None and new_preds:
        inter._defs[-1].predicates = new_preds

    # rewrite the original update: combine partials over the lifted ranges
    outer_rdom = RDom([(leaves[n][0], leaves[n][1]) for n in lifted],
                      name=f"{d.rdom.name}_outer")
    lhs_args = d.args
    new_vals2 = []
    for i, (op, _) in enumerate(decomps):
        partial = E.Call(inter, tuple(lhs_args) + tuple(outer_rdom.dims), i)
        self_call = E.Call(f, tuple(lhs_args), i)
        new_vals2.append(E.make_binary(op, self_call, partial))
    from .func import Definition, definitions_changed
    pure_names = tuple(
        v.name for v in f._defs[0].args
        if any(isinstance(a, E.Variable) and a.name == v.name
               for a in lhs_args))
    f._defs[def_index] = Definition(
        tuple(lhs_args), tuple(new_vals2), outer_rdom, [], pure_names)
    definitions_changed()
    inter.compute_root()
    return inter

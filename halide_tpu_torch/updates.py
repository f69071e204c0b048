"""Update definitions (counterpart of the JAX package's updates.py).

Update definitions are classified into array-parallel forms, as in the JAX
package (reference: src/Func.h update defs, src/Associativity.cpp):

- dense combine   f(x) = f(x) op g(r, x)        -> a convolution or einsum for
                  a sum of a product (eval_torch's contraction paths), else
                  unrolled shifted reads or a masked reduce over rdom axes
- scan            f(.., s*r+c, ..) self at -s   -> a linear scan (K2 for f32,
                  ops/scan_kernel) or min/max segmented scan; direction and
                  flipped indices like `height-r-1` both handled
- slab            f(x, r, c) = v(r, ..)         -> a write into a box
- scatter         f(e(r)) = f(e(r)) op v(r)     -> native torch scatters; small
                  data-dependent targets (histograms) per kept row, constant-
                  value row histograms through K3 (ops/rowhist_kernel)
- overwrite       f(x) = g(x)                   -> whole-array assignment
- outer loop      one small rdom dim sequential, rest re-classified per step
                  (self-reads proven disjoint from writes via interval bounds)
- sequential      anything else                 -> a Python loop over the rdom

The JAX package's TPU layout choices (the factored one-hot MXU scatter, the
K-leading lane layout, lut_gather) become native scatters with the same
results, and its environment switches are gone: each class has one route, a
kernel's build or launch failure raises, and constant-value row histograms
always take K3.

Values are held in the compute dtype of the Func's Types (htypes.
compute_dtype) while updates run. The caller owns the tensors of `current`
(pipeline._evaluate_func copies any that alias another realization), and an
update may write into them in place; every value an update reads from the
Func is computed, and copied where it is a view of the Func, before the
write that could overwrite it.
"""
from __future__ import annotations

import collections
import itertools
import math
from typing import List, Optional, Tuple

import torch

from . import expr as E
from . import spans
from .bounds import BoundsEngine, Interval
from .eval_torch import (AVal, Axis, ClampedAVal, Ctx, Realized, _apply_binop,
                         _wrap, axis_array, eval_array, evaluate, full_shape,
                         kastype, materialize, static_int, try_conv_reduce,
                         try_einsum_reduce)
from .expr import CompileError, Expr
from .ops import rowhist_kernel, scan_kernel
from .visitors import exprs_equal, substitute, walk

_COMBINE_OPS = ("add", "sub", "mul", "min", "max")

# full dense-combine grid cap (elements); larger reductions step the
# outermost rdom dim sequentially
_DENSE_COMBINE_MAX = 1 << 27

# reductions over at most this many rdom points unroll into shifted reads
# (the JAX package's HALIDE_TPU_UNROLL_TAPS default)
_UNROLL_TAPS = 16

# scatters over at most this many rdom points accumulate one point at a time
_ONEHOT_MAX_RDOM = 128

# data-dependent target dims of at most this many elements reduce per kept
# row (_dense_small_scatter)
_DENSE_SCATTER_MAX = 1024

# K3's gate, the JAX package's HT_ROWHIST_KERNEL branch: at least this many
# bins, kept rows and reduced points
_ROWHIST_MIN_K = 64
_ROWHIST_MIN_KEPT = 256
_ROWHIST_MIN_RED = 128

# last reduction-lowering decision per func name (tests/debugging spy):
# "conv" | "einsum" | "unrolled" | "dense"
_last_reduce_path: dict = {}
# every such decision since the process started, by path (eager realizes
# only: a replayed plan runs no lowering); `spans.counters()` exports them
# as contract.<path>
reduce_path_counts: collections.Counter = collections.Counter()


def _note_path(func, path: str) -> None:
    _last_reduce_path[func.name] = path
    reduce_path_counts[path] += 1


def _rdom_marked_unrolled(d, rdom_axes) -> bool:
    """True iff EVERY rdom dim of this update is marked unrolled()."""
    from .schedule import ForType
    names = {a.name for a in rdom_axes}
    if not names:
        return False
    marked = {dim.var for dim in d.schedule.dims
              if dim.is_rvar and dim.for_type == ForType.UNROLLED}
    return names <= marked


def _is_undef(e: Expr) -> bool:
    return isinstance(e, E.Intrin) and e.name == "undef"


def find_self_calls(e: Expr, func) -> List[E.Call]:
    out = []

    def fn(n):
        if isinstance(n, E.Call) and n.target is func:
            out.append(n)

    walk(e, fn)
    return out


def _aligned_self(call: E.Call, lhs_args) -> bool:
    return len(call.args) == len(lhs_args) and all(
        exprs_equal(a, b) for a, b in zip(call.args, lhs_args))


def _decompose_combine(value: Expr, func, lhs_args, value_index: int):
    """value == op(self, g) with self == func(lhs_args)[value_index] and g
    self-free. Returns (op, g) or None."""
    if isinstance(value, E.Call) and value.target is func:
        return None
    if not isinstance(value, E.Binary) or value.op not in _COMBINE_OPS:
        return None
    a, b = value.a, value.b
    a_self = isinstance(a, E.Call) and a.target is func and \
        a.value_index == value_index and _aligned_self(a, lhs_args)
    b_self = isinstance(b, E.Call) and b.target is func and \
        b.value_index == value_index and _aligned_self(b, lhs_args)
    if a_self and not find_self_calls(b, func):
        return (value.op, b)
    if b_self and value.op in ("add", "mul", "min", "max") and \
            not find_self_calls(a, func):
        return (value.op, a)
    return None


def _identity_for(op: str, t):
    if op in ("add", "sub"):
        return 0
    if op == "mul":
        return 1
    if op == "min":
        return t.max_value()
    if op == "max":
        return t.min_value()
    raise CompileError(op)


def _linear_decompose(value: Expr, func, self_call: E.Call, lhs_args):
    """value == a * self + b with a, b free of the *scanned* self-call.
    Self-calls exactly aligned with the LHS are pre-update reads of the
    current array and count as free terms. Returns (a, b) Exprs or None."""
    from .iroperator import select as hselect

    def scanned_refs(e):
        return [c for c in find_self_calls(e, func)
                if not _aligned_self(c, lhs_args)]

    def is_num(x, k):
        return _imm_value(x) == k

    def add(x, y, sign=1):
        # drop the zero terms the decomposition makes: in eager torch each
        # would be one more pass over the array
        if x.dtype == y.dtype and is_num(y, 0):
            return x
        if x.dtype == y.dtype and is_num(x, 0) and sign == 1:
            return y
        return x + y if sign == 1 else x - y

    def mul(x, y):
        if x.dtype == y.dtype and (is_num(x, 0) or is_num(y, 1)):
            return x
        if x.dtype == y.dtype and (is_num(y, 0) or is_num(x, 1)):
            return y
        return x * y

    def rec(e) -> Optional[Tuple[Expr, Expr]]:
        if isinstance(e, E.Call) and e.target is func:
            if exprs_equal(e, self_call):
                return (E.const(1, e.dtype), E.const(0, e.dtype))
            if _aligned_self(e, lhs_args):
                return (E.const(0, e.dtype), e)
            return None
        if not scanned_refs(e):
            return (E.const(0, e.dtype), e)
        if isinstance(e, E.Binary):
            ra = rec(e.a)
            rb = rec(e.b)
            if ra is None or rb is None:
                return None
            (aa, ba), (ab, bb) = ra, rb
            if e.op == "add":
                return (add(aa, ab), add(ba, bb))
            if e.op == "sub":
                return (add(aa, ab, -1), add(ba, bb, -1))
            if e.op == "mul":
                if not scanned_refs(e.a):
                    return (mul(e.a, ab), mul(e.a, bb))
                if not scanned_refs(e.b):
                    return (mul(aa, e.b), mul(ba, e.b))
                return None
            if e.op == "div" and not scanned_refs(e.b):
                return (aa / e.b, ba / e.b)
            return None
        if isinstance(e, E.Select) and not scanned_refs(e.cond):
            rt = rec(e.true_value)
            rf = rec(e.false_value)
            if rt is None or rf is None:
                return None
            return (hselect(e.cond, rt[0], rf[0]),
                    hselect(e.cond, rt[1], rf[1]))
        return None

    return rec(value)


def _resolve_rdom(d, base_ctx: Ctx) -> List[Axis]:
    axes = []
    for i, rv in enumerate(d.rdom.dims):
        mn = static_int(rv.rmin, base_ctx)
        ex = static_int(rv.rextent, base_ctx)
        axes.append(Axis(rv.name, base_ctx.ndim + i, mn, ex))
    return axes


def _eval_mask(preds, ctx: Ctx):
    if not preds:
        return None
    m = None
    for p in preds:
        pm = eval_array(p, ctx)
        m = pm if m is None else torch.logical_and(m, pm)
    return m


def _ftype(func, i: int):
    """The Type of value i of `func` (its pure definition's)."""
    return func._defs[0].values[i].dtype


def _imm_value(e: Expr):
    """The number of a constant Expr (under casts), else None."""
    while isinstance(e, E.Cast):
        e = e.value
    if isinstance(e, (E.IntImm, E.FloatImm)):
        return float(e.value)
    return None


def _const_number(e: Expr, ctx: Ctx):
    """The value of an Expr that reads no variable, Func or input (a scan's
    constant coefficient), computed on the host, else None."""
    from .ops.export_ops import host_constant
    with host_constant():
        try:
            v = evaluate(e, Ctx(0, {}, {}, {}, ctx.params, "cpu"))
        except CompileError:
            return None
        if isinstance(v, AVal):
            return float(v.const) if v.is_const() else None
        if isinstance(v, torch.Tensor) and v.numel() == 1:
            return float(v.reshape(()))
    return None


def _shares(v: torch.Tensor, cur: torch.Tensor) -> bool:
    from .ops.export_ops import exporting
    if exporting():
        return True      # a traced tensor has no storage to compare: copy
    return v.untyped_storage().data_ptr() == cur.untyped_storage().data_ptr()


def _unaliased(v: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """v, copied where it is a view of the Func's tensor `cur` (which the
    caller is about to write)."""
    return v.clone() if _shares(v, cur) else v


def _ident(op: str, t, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), _identity_for(op, t), dtype=like.dtype,
                      device=like.device)


def _reduce(op: str, x: torch.Tensor, dims) -> torch.Tensor:
    """Reduce x over `dims` (kept as size 1) with the combine op."""
    dims = tuple(dims)
    if op in ("add", "sub"):
        return torch.sum(x, dim=dims, keepdim=True)
    if op == "mul":
        for a in sorted(dims, reverse=True):
            x = torch.prod(x, dim=a, keepdim=True)
        return x
    if op == "min":
        return torch.amin(x, dim=dims, keepdim=True)
    return torch.amax(x, dim=dims, keepdim=True)


def _fold(op: str, acc: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Accumulate one term of a reduction (sub accumulates a sum)."""
    if op in ("add", "sub"):
        return acc + v
    if op == "mul":
        return acc * v
    if op == "min":
        return torch.minimum(acc, v)
    return torch.maximum(acc, v)


def apply_update(func, d, current: List, base_ctx: Ctx,
                 allow_self_reads: bool = False) -> List:
    """Apply one update definition to `current` (list of full-shape
    tensors, compute dtype).

    base_ctx: axes = func pure dims over its realized box; realizations
    already map id(func) -> Realized(current tensors)."""
    lhs = d.args
    init_args = func._defs[0].args
    aligned = all(
        isinstance(a, E.Variable) and a.name == v.name
        for a, v in zip(lhs, init_args))

    if d.rdom is None:
        if aligned:
            return _dense_overwrite(func, d, current, base_ctx)
        r = _scatter_update(func, d, current, base_ctx, rdom_axes=[],
                            allow_self_reads=allow_self_reads)
        if r is not None:
            return r
        return _sequential_update(func, d, current, base_ctx, [])

    rdom_axes = _resolve_rdom(d, base_ctx)
    if any(ax.extent <= 0 for ax in rdom_axes):
        return current          # zero iterations: a no-op

    if aligned:
        r = _try_dense_combine(func, d, current, base_ctx, rdom_axes)
        if r is not None:
            return r
    else:
        r = _try_scan(func, d, current, base_ctx, rdom_axes)
        if r is not None:
            return r
        r = _scatter_update(func, d, current, base_ctx, rdom_axes,
                            allow_self_reads=allow_self_reads)
        if r is not None:
            return r
    r = _try_outer_loop(func, d, current, base_ctx, rdom_axes)
    if r is not None:
        return r
    return _sequential_update(func, d, current, base_ctx, rdom_axes)


# ---------------------------------------------------------------------------

def _out_shape(base_ctx: Ctx):
    return full_shape(base_ctx, list(base_ctx.axes.values()))


def _dense_overwrite(func, d, current, base_ctx: Ctx):
    out = []
    shape = _out_shape(base_ctx)
    mask = _eval_mask(d.predicates, base_ctx)
    for i, v in enumerate(d.values):
        if _is_undef(v):
            out.append(current[i])
            continue
        arr = kastype(eval_array(v, base_ctx).expand(shape), _ftype(func, i))
        if mask is not None:
            arr = torch.where(mask.expand(shape), arr, current[i])
        out.append(arr)
    return out


def _try_dense_combine(func, d, current, base_ctx: Ctx, rdom_axes):
    decomps = []
    for i, v in enumerate(d.values):
        if _is_undef(v):
            decomps.append(None)
            continue
        dc = _decompose_combine(v, func, d.args, i)
        if dc is None:
            # value entirely self-free: last-iteration-wins overwrite
            if not find_self_calls(v, func) and not d.predicates:
                dc = ("overwrite", v)
            else:
                return None
        decomps.append(dc)
    inner = base_ctx.extended(rdom_axes)
    shape = _out_shape(base_ctx)
    taps = math.prod(a.extent for a in rdom_axes)
    grid = taps * math.prod(shape)
    mask = _eval_mask(d.predicates, inner)
    red_axes = tuple(inner.ndim - 1 - a.rpos for a in rdom_axes)
    # update().unroll(rvar) on every rdom dim forces the unrolled lowering
    # (reference: src/Func.h Stage::unroll on RVars); without marks the
    # tap count picks
    unroll_forced = _rdom_marked_unrolled(d, rdom_axes)
    out = []
    for i, dc in enumerate(decomps):
        if dc is None:
            out.append(current[i])
            continue
        t = _ftype(func, i)
        op, g = dc
        if op == "overwrite":
            bind = dict(inner.bindings)
            for a in rdom_axes:
                bind[a.name] = AVal({}, a.min + a.extent - 1)
            arr = eval_array(g, base_ctx.with_bindings(bind))
            out.append(kastype(arr, t).expand(shape))
            continue
        if op == "add" and mask is None and not unroll_forced:
            # the contraction paths: a convolution first, then einsum
            # above the unroll's tap count (small-tap sums unroll into
            # one pass of shifted reads instead of a taps-deep contraction)
            try:
                red, path = try_conv_reduce(
                    g, inner, [a.name for a in rdom_axes]), "conv"
            except CompileError:
                red = None
            if red is None and taps > _UNROLL_TAPS:
                red, path = try_einsum_reduce(g, inner, red_axes), "einsum"
            if red is not None:
                _note_path(func, path)
                if red.dim() > base_ctx.ndim:
                    red = red.reshape(red.shape[-base_ctx.ndim:])
                out.append(_apply_binop(op, t, current[i], kastype(red, t))
                           .expand(shape))
                continue
        if unroll_forced or 1 < taps <= _UNROLL_TAPS:
            # static unroll: bind each rdom point to a constant and fold;
            # every term is a (shifted) read over the plain output grid
            try:
                acc = None
                for combo in itertools.product(
                        *[range(a.extent) for a in rdom_axes]):
                    bind = dict(base_ctx.bindings)
                    for a, k in zip(rdom_axes, combo):
                        bind[a.name] = AVal({}, a.min + k)
                    cb = base_ctx.with_bindings(bind)
                    v = eval_array(g, cb)
                    m = _eval_mask(d.predicates, cb)
                    if m is not None:
                        v = torch.where(m, v, _ident(op, d.values[i].dtype,
                                                     v))
                    acc = v if acc is None else _fold(op, acc, v)
                _note_path(func, "unrolled")
                red = kastype(acc, t)
                if red.dim() > base_ctx.ndim:
                    red = red.reshape(red.shape[-base_ctx.ndim:])
                out.append(_apply_binop(op, t, current[i], red).expand(shape))
                continue
            except CompileError:
                pass
        if grid > _DENSE_COMBINE_MAX and len(rdom_axes) > 1:
            # the dense reduction materializes the whole product grid; step
            # the outermost rdom dim sequentially instead
            return None
        _note_path(func, "dense")
        garr = eval_array(g, inner)
        garr = garr.expand(torch.broadcast_shapes(
            garr.shape, full_shape(inner, rdom_axes)))
        if mask is not None:
            garr = torch.where(mask, garr, _ident(op, d.values[i].dtype, garr))
        red = _reduce(op, garr, red_axes)
        if red.dim() > base_ctx.ndim:
            red = red.reshape(red.shape[-base_ctx.ndim:])
        red = kastype(red, t)
        out.append(_apply_binop(op, t, current[i], red).expand(shape))
    return out


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------

def _affine_in_var(e: Expr, name: str, ctx: Ctx):
    """e == s*var + c with s in {+1,-1} and c static -> (s, c), else None."""
    try:
        v = evaluate(e, ctx.extended([Axis(name, ctx.ndim, 0, 1)]))
    except CompileError:
        return None
    if not isinstance(v, AVal):
        return None
    if set(v.coeffs) != {name}:
        return None
    s = v.coeffs[name]
    if s not in (1, -1):
        return None
    return (s, v.const)


def _hillis_steele(elems, combine, axis: int):
    """Inclusive scan of the tuple `elems` along `axis` in log2(n) rounds:
    after the round of shift k, element i holds the combine of the window
    of 2k elements ending at i."""
    n = elems[0].shape[axis]
    k = 1
    while k < n:
        left = tuple(e.narrow(axis, 0, n - k) for e in elems)
        right = tuple(e.narrow(axis, k, n - k) for e in elems)
        new = combine(left, right)
        elems = tuple(torch.cat([e.narrow(axis, 0, k), nw], dim=axis)
                      for e, nw in zip(elems, new))
        k *= 2
    return elems


def _try_scan(func, d, current, base_ctx: Ctx, rdom_axes):
    """f(.., s*r + c, ..) = a * f(.. prev ..) + b  or  op(prev, g)."""
    if len(rdom_axes) != 1:
        return None
    rax = rdom_axes[0]
    rname = rax.name
    init_args = func._defs[0].args
    # locate the scanned dim: arg affine in r with stride +-1; others bare
    # pure vars at their own positions
    scan_dim = None
    s_c = None
    for i, a in enumerate(d.args):
        if isinstance(a, E.Variable) and a.name == init_args[i].name:
            continue
        aff = _affine_in_var(a, rname, base_ctx)
        if aff is None or scan_dim is not None:
            return None
        scan_dim = i
        s_c = aff
    if scan_dim is None:
        return None
    s, c0 = s_c
    if len(d.values) != 1:
        return None
    value = d.values[0]
    self_calls = find_self_calls(value, func)
    if not self_calls:
        return None
    # classify self-calls: aligned (pre-update reads) vs the scan reference
    scan_ref = None
    for sc in self_calls:
        if _aligned_self(sc, d.args):
            continue
        ok = True
        for i, a in enumerate(sc.args):
            if i == scan_dim:
                aff = _affine_in_var(a, rname, base_ctx)
                if aff is None or aff[0] != s or aff[1] - c0 != -s:
                    ok = False
            else:
                if not (isinstance(a, E.Variable)
                        and a.name == d.args[i].name):
                    ok = False
        if not ok:
            return None
        if scan_ref is None:
            scan_ref = sc
        elif not exprs_equal(sc, scan_ref):
            return None
    if scan_ref is None:
        return None

    lin = _linear_decompose(value, func, scan_ref, d.args)
    opscan = None
    if lin is None:
        if isinstance(value, E.Binary) and value.op in ("min", "max"):
            a, b = value.a, value.b

            def free(e):
                return not [c for c in find_self_calls(e, func)
                            if not _aligned_self(c, d.args)]
            if exprs_equal(a, scan_ref) and free(b):
                opscan = (value.op, b)
            elif exprs_equal(b, scan_ref) and free(a):
                opscan = (value.op, a)
        if opscan is None:
            return None

    inner = base_ctx.extended([rax])
    mask = _eval_mask(d.predicates, inner)
    cur = current[0]
    t = _ftype(func, 0)
    nd = cur.dim()
    scan_np = nd - 1 - scan_dim
    ax = base_ctx.axes[init_args[scan_dim].name]
    n = rax.extent
    # positions p(r) = c0 + s*r over r in [rmin, rmin+n)
    if s == 1:
        pos_lo = c0 + rax.min
    else:
        pos_lo = c0 - (rax.min + n - 1)
    arr_lo = pos_lo - ax.min
    # the initial value lives just before the first scanned position
    init_idx = arr_lo - 1 if s == 1 else arr_lo + n

    layout_axes = [a for nm, a in inner.axes.items()
                   if nm != init_args[scan_dim].name]
    inner_shape = full_shape(inner, layout_axes)
    r_np_inner = inner.ndim - 1 - rax.rpos

    def layout(x):
        """inner-ctx (r-indexed) tensor -> the Func's layout, r mapped to
        positions along the scanned dim (ascending array order)."""
        x = x.expand(inner_shape).movedim(r_np_inner, 0)
        x = x.reshape((n,) + tuple(x.shape[-nd:]))
        x = x.squeeze(1 + scan_np).movedim(0, scan_np)
        if s == -1:
            x = x.flip(scan_np)   # ascending r == descending position
        return x

    init_vals = cur.narrow(scan_np, init_idx, 1)
    span = cur.narrow(scan_np, arr_lo, n)
    backward = s == -1
    f32 = cur.dtype == torch.float32

    if lin is not None:
        a_e, b_e = lin
        dconst = _const_number(a_e, inner)
        if dconst is not None and mask is None and f32:
            # constant-coefficient recurrence (IIR with a static alpha), K2a
            # (reference: apps/iir_blur/iir_blur_generator.cpp:13-33)
            b_arr = _unaliased(kastype(layout(eval_array(b_e, inner)), t),
                               cur)
            with spans.span(spans.SCAN, func.name):
                scan_kernel.linear_scan(span, b_arr, init_vals, scan_np,
                                        backward, a_const=dconst)
            return [cur]
        a_arr = kastype(layout(eval_array(a_e, inner)), t)
        b_arr = kastype(layout(eval_array(b_e, inner)), t)
        if mask is not None:
            m = layout(mask)
            a_arr = torch.where(m, a_arr, torch.zeros_like(a_arr))
            b_arr = torch.where(m, b_arr, span)
        b_arr = _unaliased(b_arr, cur)
        if f32:
            # per-element coefficient (a predicated or varying recurrence),
            # K2b
            a_arr = _unaliased(a_arr, cur)
            with spans.span(spans.SCAN, func.name):
                scan_kernel.linear_scan(span, b_arr, init_vals, scan_np,
                                        backward, a=a_arr)
            return [cur]
        # other types: the (a, b) pair scan in log-depth rounds of torch
        # ops, exact for integers (arithmetic mod 2^bits)
        elems = (a_arr.expand(b_arr.shape), b_arr)
        init_e = (torch.zeros_like(init_vals), init_vals)

        def combine(lft, rgt):
            (al, bl), (ar, br) = lft, rgt
            return (ar * al, ar * bl + br)
    else:
        op, g = opscan
        fn = torch.minimum if op == "min" else torch.maximum
        g_arr = kastype(layout(eval_array(g, inner)), t)
        if mask is not None:
            m = layout(mask)
            seg_reset = torch.logical_not(m)
            u = torch.where(m, g_arr, span)
        else:
            seg_reset = torch.zeros(g_arr.shape, dtype=torch.bool,
                                    device=cur.device)
            u = g_arr
        elems = (seg_reset.expand(u.shape), u)
        init_e = (torch.zeros(init_vals.shape, dtype=torch.bool,
                              device=cur.device), init_vals)

        def combine(lft, rgt):
            (sl, ul), (sr, ur) = lft, rgt
            return (torch.logical_or(sl, sr), torch.where(sr, ur, fn(ul, ur)))

    if backward:
        elems = tuple(e.flip(scan_np) for e in elems)
    full = tuple(torch.cat([i0, e], dim=scan_np)
                 for i0, e in zip(init_e, elems))
    res = _hillis_steele(full, combine, scan_np)[-1].narrow(scan_np, 1, n)
    if backward:
        res = res.flip(scan_np)
    span.copy_(kastype(res, t))
    return [cur]


# ---------------------------------------------------------------------------
# scatter / slab updates
# ---------------------------------------------------------------------------

def _scatter_update(func, d, current, base_ctx: Ctx, rdom_axes,
                    allow_self_reads: bool = False):
    """LHS has computed indices. Tries the slab (a box write) before the
    scatters."""
    inner = base_ctx.extended(rdom_axes) if rdom_axes else base_ctx
    init_args = func._defs[0].args
    ops = []
    for i, v in enumerate(d.values):
        if _is_undef(v):
            return None
        dc = _decompose_combine(v, func, d.args, i)
        if dc is not None and dc[0] in _COMBINE_OPS:
            ops.append(dc)
        else:
            selfs = find_self_calls(v, func)
            if not selfs:
                ops.append(("set", v))
            elif allow_self_reads:
                # caller proved the reads are disjoint from the writes
                ops.append(("set", v))
            else:
                return None

    # classify LHS dims
    kinds = []    # ('axis',) | ('const', c) | ('rspan', Axis, stride, c)
    used_rvars = {}
    rax_by_name = {a.name: a for a in rdom_axes}
    for i, a in enumerate(d.args):
        if isinstance(a, E.Variable) and a.name == init_args[i].name:
            kinds.append(("axis",))
            continue
        v = evaluate(a, inner)
        clamped = isinstance(v, ClampedAVal)
        av = v.aval if clamped else v
        if isinstance(av, AVal) and av.is_const() and not clamped:
            kinds.append(("const", av.const))
            continue
        sv = av.single_var() if isinstance(av, AVal) else None
        if (sv is not None and sv in rax_by_name and not clamped
                and av.coeffs[sv] in (1, -1) and sv not in used_rvars):
            used_rvars[sv] = i
            kinds.append(("rspan", rax_by_name[sv], av.coeffs[sv], av.const))
            continue
        kinds.append(None)

    mask = _eval_mask(d.predicates, inner)
    if all(k is not None for k in kinds):
        r = _slab_update(func, d, current, base_ctx, inner, rdom_axes,
                         kinds, ops, mask)
        if r is not None:
            return r
    if not _dense_scatter_applies(func, d, current, rdom_axes, ops):
        # the per-row reduction (inside _general_scatter) beats `total`
        # whole-array passes whenever it applies; only fall back to the
        # unrolled loop when it does not
        r = _try_unrolled_onehot(func, d, current, base_ctx, rdom_axes, ops)
        if r is not None:
            return r
    if rdom_axes and any(op == "set" for op, _ in ops):
        # Halide defines sequential RDom order for overwrites; a scatter of
        # duplicate indices has none. 'set' may reach the general scatter
        # only when every rdom var addresses its own LHS dim with unit
        # stride (index tuples then unique across the domain); otherwise
        # decline so apply_update routes to the order-preserving paths.
        covered = {k[1].name for k in kinds
                   if k is not None and k[0] == "rspan"}
        if any(ax.name not in covered for ax in rdom_axes):
            return None
    return _general_scatter(func, d, current, base_ctx, inner, rdom_axes,
                            ops, mask)


def _slab_update(func, d, current, base_ctx, inner, rdom_axes, kinds, ops,
                 mask):
    """All LHS dims are identity axes, constants, or full rvar spans: the
    write region is a box -> evaluate the block and write it. rvar axes not
    consumed by the LHS ("free") are reduced per the combine op; a masked
    or `set` update with free rvars stays on the scatter path (duplicate
    writes are order-sensitive)."""
    init_args = func._defs[0].args
    nd = current[0].dim()
    spanned = {k[1].name for k in kinds if k is not None and k[0] == "rspan"}
    free_rvars = [a for a in rdom_axes if a.name not in spanned]
    if free_rvars and (mask is not None or any(o[0] == "set" for o in ops)):
        return None

    # target box: offsets + sizes per tensor axis
    offsets = [0] * nd
    sizes = list(current[0].shape)
    for j, k in enumerate(kinds):
        npax = nd - 1 - j
        ax_min = base_ctx.axes[init_args[j].name].min
        if k[0] == "axis":
            continue
        if k[0] == "const":
            offsets[npax] = k[1] - ax_min
            sizes[npax] = 1
        else:
            _, rax, stride, c = k
            lo = c + rax.min if stride == 1 else c - (rax.min + rax.extent - 1)
            offsets[npax] = lo - ax_min
            sizes[npax] = rax.extent
    if any(o < 0 or o + s > cs
           for o, s, cs in zip(offsets, sizes, current[0].shape)):
        return None   # box exceeds the realization: let scatter drop OOB

    layout_axes = list(rdom_axes) + [
        base_ctx.axes[init_args[j].name]
        for j, k2 in enumerate(kinds) if k2[0] == "axis"]
    tgt = full_shape(inner, layout_axes)
    # tensor axis p of the box takes the base axis or the spanned rvar axis
    perm, flips = [], []
    for p in range(nd):
        k = kinds[nd - 1 - p]
        if k[0] == "rspan":
            _, rax, stride, _c = k
            perm.append(inner.ndim - 1 - rax.rpos)
            if stride == -1:
                flips.append(p)
        else:
            perm.append(inner.ndim - nd + p)
    unused = [a for a in range(inner.ndim) if a not in perm]

    def layout(x, reduce_op=None):
        """inner-ctx value -> block of shape `sizes` (tensor order)."""
        # broadcast only over rvar axes + identity-dim base axes; base axes
        # of const/rspan dims stay size 1 (their pure vars cannot appear in
        # the update)
        x = x.expand(tgt)
        if free_rvars:
            x = _reduce(reduce_op,
                        x, [inner.ndim - 1 - a.rpos for a in free_rvars])
        x = x.permute(unused + perm)
        x = x.reshape(tuple(x.shape[len(unused):]))
        if flips:
            x = x.flip(flips)
        # const dims carry the full box axis (size box-extent or 1): crop
        idx = tuple(
            slice(0, 1) if sizes[p] == 1 and x.shape[p] != 1 else slice(None)
            for p in range(nd))
        return x[idx].expand(sizes)

    news = []
    for i, (op, g) in enumerate(ops):
        cur = current[i]
        t = _ftype(func, i)
        garr = eval_array(g, inner)
        if mask is not None and op != "set":
            garr = torch.where(mask, garr, _ident(op, d.values[i].dtype, garr))
        block = kastype(layout(garr, reduce_op=op if op != "set" else None), t)
        sub = cur
        for p in range(nd):
            sub = sub.narrow(p, offsets[p], sizes[p])
        if op == "set":
            nv = torch.where(layout(mask), block, sub) \
                if mask is not None else block
        else:
            nv = _apply_binop(op, t, sub, block)
        news.append((sub, _unaliased(nv, cur)))
    for sub, nv in news:
        sub.copy_(nv)
    return list(current)


def _try_unrolled_onehot(func, d, current, base_ctx: Ctx, rdom_axes, ops):
    """Small-rdom scatter -> dense accumulation: evaluate the index and
    value fields ONCE over the rdom grid, then loop over the rdom points
    applying out (op)= where(coords == idx, v, identity)."""
    if not rdom_axes:
        return None
    total = math.prod(a.extent for a in rdom_axes)
    if total > _ONEHOT_MAX_RDOM:
        return None
    if any(op[0] not in _COMBINE_OPS for op in ops):
        return None
    # the batched pre-evaluation reads the pre-update state once, which is
    # only sequential-equivalent if nothing here reads the func itself
    for _op, g in ops:
        if find_self_calls(g, func):
            return None
    for p in d.predicates:
        if find_self_calls(p, func):
            return None
    init_args = func._defs[0].args
    identity = [isinstance(a, E.Variable) and a.name == init_args[i].name
                for i, a in enumerate(d.args)]
    if all(identity):
        return None

    inner = base_ctx.extended(rdom_axes)
    base_nd = base_ctx.ndim
    shape = _out_shape(base_ctx)
    inner_full = full_shape(inner, list(inner.axes.values()))

    def flat(x):
        """inner-ctx value -> (R, *base shape) with rdom axes flattened."""
        x = x.expand(inner_full)
        return x.reshape((-1,) + tuple(x.shape[-base_nd:]))

    mask_full = _eval_mask(d.predicates, inner)
    mask_full = flat(mask_full) if mask_full is not None else None
    idx_full = {}
    for j, a2 in enumerate(d.args):
        if identity[j]:
            continue
        idx_full[j] = flat(materialize(evaluate(a2, inner), inner))
    g_full = [flat(kastype(materialize(evaluate(g, inner), inner),
                           _ftype(func, i)))
              for i, (_op, g) in enumerate(ops)]
    coords = {j: axis_array(base_ctx.axes[init_args[j].name], base_ctx)
              for j in idx_full}

    cur = [c.expand(shape) for c in current]
    for r in range(total):
        m = mask_full[r] if mask_full is not None else None
        for j, arr in idx_full.items():
            hit = arr[r] == coords[j]
            m = hit if m is None else torch.logical_and(m, hit)
        for i, (op, _g) in enumerate(ops):
            t = _ftype(func, i)
            v = g_full[i][r]
            fill = _ident(op, d.values[i].dtype, v)
            cur[i] = _apply_binop(op, t, cur[i], torch.where(m, v, fill))
    return [c.expand(shape) for c in cur]


def _dd_elems(cur, identity) -> int:
    """Elements of the data-dependent (non-identity) dims of `cur`."""
    nd = cur.dim()
    return math.prod(cur.shape[a] for a in range(nd)
                     if not identity[nd - 1 - a])


def _dense_scatter_applies(func, d, current, rdom_axes, ops) -> bool:
    """Whether _general_scatter will take its per-row reduction
    (_dense_small_scatter): reorderable ops over an rdom, into at most
    _DENSE_SCATTER_MAX data-dependent elements. The JAX package also gates
    on the size of its compare-reduce temporaries; the scatters here make
    none."""
    if not rdom_axes:
        return False
    if any(op not in _COMBINE_OPS for op, _ in ops):
        return False
    init_args = func._defs[0].args
    identity = [isinstance(a, E.Variable) and a.name == init_args[i].name
                for i, a in enumerate(d.args)]
    return _dd_elems(current[0], identity) <= _DENSE_SCATTER_MAX


def _rowhist_scale(vexpr, cur_float: bool, red_elems: int):
    """The constant g of a row histogram K3 can take, else None: g is a
    constant, exact in bf16, |g| * red < 2^24 (the counts stay exact in
    f32), and an integer where the Func is (the JAX package's gate)."""
    g = _imm_value(vexpr) if vexpr is not None else None
    if g is None:
        return None
    if torch.tensor(g, dtype=torch.bfloat16).item() != g:
        return None
    if abs(g) * red_elems >= (1 << 24):
        return None
    if not cur_float and g != int(g):
        return None
    return g


def _dense_small_scatter(cur, op, garr, np_idx, t, vtype, identity, inner,
                         rdom_axes, vexpr=None):
    """Scatter whose data-dependent target dims are SMALL (histograms, bin
    reductions), reduced per kept row:
        out[.., k, ..] op= reduce_r(g[r, ..] where lin(r, ..) == k)
    Identity-indexed dims are batch dims (per-row histograms keep their row
    axis); only the data-dependent dims are flattened into the K bins.
    Reorderable ops only -- `set` with duplicate indices is order-sensitive.
    Returns the new tensor."""
    nd = cur.dim()
    dd_np = [a for a in range(nd) if not identity[nd - 1 - a]]
    K = math.prod(cur.shape[a] for a in dd_np)
    lin = None
    oob = None
    for a in dd_np:                       # tensor-major flattening
        ia = np_idx[a].to(torch.int32)
        lin = ia if lin is None else lin * cur.shape[a] + ia
        o = (ia < 0) | (ia >= cur.shape[a])
        oob = o if oob is None else oob | o
    lin = torch.where(oob, K, lin)        # out-of-bounds writes drop
    red_np = [inner.ndim - 1 - ax.rpos for ax in rdom_axes]
    gshape = torch.broadcast_shapes(lin.shape, garr.shape)
    keep_np = [a for a in range(len(gshape)) if a not in red_np]
    kept_shape = [gshape[a] for a in keep_np]
    kept = math.prod(kept_shape)
    red = math.prod(gshape[a] for a in red_np)

    def rows(x):
        """grid tensor -> (kept, red), the rdom axes last."""
        return x.expand(gshape).permute(keep_np + red_np).reshape(kept, red)

    lin2 = rows(lin)
    contrib = None
    if op in ("add", "sub") and K >= _ROWHIST_MIN_K \
            and kept >= _ROWHIST_MIN_KEPT and red >= _ROWHIST_MIN_RED:
        scale = _rowhist_scale(vexpr, cur.is_floating_point(), red)
        if scale is not None:
            # constant-value row histogram: K3 (op == "sub" stays: the
            # caller's combine below subtracts)
            contrib = rowhist_kernel.rowhist(lin2, K, scale)
    if contrib is None:
        g2 = rows(garr)
        idx = lin2.to(torch.int64)
        if op in ("add", "sub"):
            acc_t = torch.promote_types(g2.dtype, torch.float32) \
                if g2.is_floating_point() else torch.int64
            acc = torch.zeros((kept, K + 1), dtype=acc_t, device=cur.device)
            acc.scatter_add_(1, idx, g2.to(acc_t))
        else:
            acc_t = torch.int64 if op == "mul" and \
                not g2.is_floating_point() else g2.dtype
            acc = torch.full((kept, K + 1), _identity_for(op, vtype),
                             dtype=acc_t, device=cur.device)
            acc.scatter_reduce_(1, idx, g2.to(acc_t),
                                {"mul": "prod", "min": "amin",
                                 "max": "amax"}[op])
        contrib = acc[:, :K]
    # contrib: (kept, K) -> (base grid dims, 1 at dd axes) + the dd dims,
    # each folded back into its tensor slot
    contrib = contrib.reshape(tuple(kept_shape)
                              + tuple(cur.shape[a] for a in dd_np))
    for i in range(len(dd_np) - 1, -1, -1):
        src = nd + i
        p = dd_np[i]
        contrib = contrib.squeeze(p).movedim(src - 1, p)
    return _apply_binop(op, t, cur, kastype(contrib, t))


def _scatter_into(cur: torch.Tensor, op: str, idx, vals: torch.Tensor, t):
    """cur[idx] (op)= vals in place, index tuples outside cur dropped with
    nothing read back to the host (a boolean mask would be): a dropped
    combine writes the op's no-op value into element 0; a dropped set,
    which has no such value, goes to a scratch slot past the end of a flat
    copy of cur."""
    if cur.numel() == 0:
        return
    valid = None
    flat = None
    for k, ix in enumerate(idx):
        ix = ix.to(torch.int64)
        ok = (ix >= 0) & (ix < cur.shape[k])
        valid = ok if valid is None else valid & ok
        flat = ix if flat is None else flat * cur.shape[k] + ix
    v = vals.expand(valid.shape).reshape(-1)
    valid, flat = valid.reshape(-1), flat.reshape(-1)
    if op == "set":
        n = cur.numel()
        buf = torch.empty(n + 1, dtype=cur.dtype, device=cur.device)
        buf[:n] = cur.view(-1)
        buf[torch.where(valid, flat, n)] = v
        cur.view(-1).copy_(buf[:n])
    else:
        flat = torch.where(valid, flat, 0)
        if op == "sub":
            v = torch.zeros_like(v) - v
        v = torch.where(valid, v, _noop_value(op, v))
        if op in ("add", "sub"):
            cur.view(-1).index_put_((flat,), v, accumulate=True)
        else:
            cur.view(-1).scatter_reduce_(
                0, flat, v, {"mul": "prod", "min": "amin", "max": "amax"}[op])
    if t.is_uint() and t.bits in (16, 32):
        cur.copy_(_wrap(cur, t))


def _noop_value(op: str, like: torch.Tensor) -> torch.Tensor:
    """The value whose combine by `op` leaves every element of like's dtype
    as it is, -0.0 and NaN included (x + -0.0 == x; min with +inf)."""
    dt = like.dtype
    if dt == torch.bool:
        v = {"add": False, "sub": False, "mul": True, "min": True,
             "max": False}[op]
    elif dt.is_floating_point:
        v = {"add": -0.0, "sub": -0.0, "mul": 1.0, "min": math.inf,
             "max": -math.inf}[op]
    else:
        info = torch.iinfo(dt)
        v = {"add": 0, "sub": 0, "mul": 1, "min": info.max,
             "max": info.min}[op]
    return torch.full((), v, dtype=dt, device=like.device)


def _general_scatter(func, d, current, base_ctx, inner, rdom_axes, ops,
                     mask):
    init_args = func._defs[0].args
    idx_arrays = [materialize(evaluate(a, inner), inner) for a in d.args]
    identity = [isinstance(a, E.Variable) and a.name == init_args[i].name
                for i, a in enumerate(d.args)]
    grid_axes = list(rdom_axes) + [
        base_ctx.axes[init_args[i].name]
        for i, ident in enumerate(identity) if ident]
    mins = [base_ctx.axes[v.name].min for v in init_args]
    ishape = full_shape(inner, grid_axes)
    np_idx = [(idx_arrays[j] - mins[j]).expand(ishape)
              for j in reversed(range(len(idx_arrays)))]
    # every value and index is computed before any write
    plans = []
    for i, (op, g) in enumerate(ops):
        t = _ftype(func, i)
        cur = current[i]
        garr = kastype(materialize(evaluate(g, inner), inner), t) \
            .expand(ishape)
        this_idx = list(np_idx)
        if mask is not None:
            bmask = mask.expand(ishape)
            if op == "set":   # push masked-out writes out of bounds (drop)
                this_idx = [torch.where(bmask, ix, cur.shape[k])
                            for k, ix in enumerate(this_idx)]
            else:
                garr = torch.where(bmask, garr,
                                   _ident(op, d.values[i].dtype, garr))
        if op != "set" and rdom_axes and \
                _dd_elems(cur, identity) <= _DENSE_SCATTER_MAX:
            plans.append(("dense", _dense_small_scatter(
                cur, op, garr, this_idx, t, d.values[i].dtype, identity,
                inner, rdom_axes, vexpr=g)))
        else:
            plans.append(("scatter", (op, this_idx, _unaliased(garr, cur))))
    out = []
    for i, (kind, what) in enumerate(plans):
        if kind == "dense":
            out.append(what)
        else:
            op, this_idx, garr = what
            _scatter_into(current[i], op, this_idx, garr, _ftype(func, i))
            out.append(current[i])
    return out


# ---------------------------------------------------------------------------
# outer sequential loop
# ---------------------------------------------------------------------------

class _SubRDom:
    """Residual reduction domain after binding one dim."""
    def __init__(self, dims):
        self.dims = dims
        self.predicates: List[Expr] = []
        self.name = "sub"


def _try_outer_loop(func, d, current, base_ctx: Ctx, rdom_axes):
    """Pick one small rdom dim to iterate sequentially; the residual update
    must classify densely, with self-reads proven disjoint from the writes
    via interval bounds (the ParallelRVar analog)."""
    from .func import Definition

    if not rdom_axes:
        return None
    values_selfs = [find_self_calls(v, func) for v in d.values]

    def resolver(name, args):
        if name == "param":
            return base_ctx.params.get(id(args[0]))
        obj, i = args[0], args[1]
        real = base_ctx.realizations.get(id(obj))
        if real is None:
            return None
        if name == "buffer_min":
            return real.mins[i]
        return real.arrays[0].shape[real.arrays[0].dim() - 1 - i]

    engine = BoundsEngine(resolver=resolver)

    # only the OUTERMOST rdom dim may be peeled: the reference iterates the
    # first dim innermost, so peeling the last dim preserves update order
    k = len(rdom_axes) - 1
    rax = rdom_axes[k]
    if rax.extent > 64:
        return None
    scope = {nm: Interval(a.min, a.min + a.extent - 1)
             for nm, a in base_ctx.axes.items()}
    for j, a2 in enumerate(rdom_axes):
        if j != k:
            scope[a2.name] = Interval(a2.min, a2.min + a2.extent - 1)
    # disjointness: for every non-aligned self-call, some dim's read
    # interval must not intersect the write interval once r_k is a point
    for selfs in values_selfs:
        for sc in selfs:
            if _aligned_self(sc, d.args):
                continue
            disjoint_dim = False
            for j in range(len(d.args)):
                for point in (rax.min, rax.min + rax.extent - 1):
                    sp = dict(scope)
                    sp[rax.name] = Interval(point, point)
                    w = engine.bounds(d.args[j], sp)
                    r = engine.bounds(sc.args[j], sp)
                    if w.hi < r.lo or r.hi < w.lo:
                        disjoint_dim = True
                if disjoint_dim:
                    break
            if not disjoint_dim:
                return None
    other_rvars = [rv for rv in d.rdom.dims if rv.name != rax.name]
    sub_rdom = _SubRDom(other_rvars) if other_rvars else None
    cur = list(current)
    init_args = func._defs[0].args
    for step in range(rax.extent):
        sub = {rax.name: E.IntImm(E.Int(32), rax.min + step)}
        d2 = Definition.__new__(Definition)
        d2.args = tuple(substitute(a, sub) if isinstance(a, Expr) else a
                        for a in d.args)
        d2.values = tuple(substitute(v, sub) for v in d.values)
        d2.rdom = sub_rdom
        d2.predicates = [substitute(p, sub) for p in d.predicates]
        d2.schedule = d.schedule
        ctx2 = Ctx(base_ctx.ndim, base_ctx.axes, base_ctx.bindings,
                   dict(base_ctx.realizations), base_ctx.params,
                   base_ctx.device, trace=base_ctx.trace)
        ctx2.realizations[id(func)] = Realized(
            cur, [base_ctx.axes[v.name].min for v in init_args], func.name)
        cur = apply_update(func, d2, cur, ctx2, allow_self_reads=True)
    return cur


# ---------------------------------------------------------------------------

def _sequential_update(func, d, current, base_ctx: Ctx, rdom_axes):
    """Fully general fallback: a Python loop over the flattened rdom (the
    JAX package's lax.fori_loop), one write per iteration, vectorized over
    the pure vars."""
    init_args = func._defs[0].args
    sizes = [a.extent for a in rdom_axes]
    mins = [a.min for a in rdom_axes]
    total = math.prod(sizes)
    if total == 0:
        return current
    box_mins = [base_ctx.axes[v.name].min for v in init_args]
    nd = len(init_args)
    identity_dims = [
        isinstance(a, E.Variable) and a.name == init_args[i].name
        for i, a in enumerate(d.args)]
    shape = current[0].shape
    dev = current[0].device
    # a value evaluated in the loop has 1s at the data-dependent dims
    vshape = [shape[a] if identity_dims[nd - 1 - a] else 1
              for a in range(nd)]
    # the identity dims' index tensors, shaped to broadcast into vshape
    spans = {a: torch.arange(shape[a], device=dev).reshape(
        [shape[a] if b == a else 1 for b in range(nd)])
        for a in range(nd) if identity_dims[nd - 1 - a]}

    cur = list(current)
    for k in range(total):
        bind = dict(base_ctx.bindings)
        rem = k
        for i in reversed(range(len(rdom_axes))):
            bind[rdom_axes[i].name] = AVal({}, rem % sizes[i] + mins[i])
            rem //= sizes[i]
        ctx2 = base_ctx.with_bindings(bind)
        ctx2.realizations = dict(base_ctx.realizations)
        ctx2.realizations[id(func)] = Realized(cur, box_mins, func.name)
        pred = None
        for p in d.predicates:
            pv = eval_array(p, ctx2)
            pred = pv if pred is None else torch.logical_and(pred, pv)
        # the data-dependent positions stay on the card: an out-of-bounds
        # write is clamped into range and writes back the old value
        idx = []
        keep = pred.expand(vshape) if pred is not None else None
        for j in reversed(range(nd)):
            a = nd - 1 - j
            if identity_dims[j]:
                idx.append(spans[a])
                continue
            v = materialize(evaluate(d.args[j], ctx2), ctx2)
            pos = v.reshape(()).to(torch.int64) - box_mins[j]
            ok = (pos >= 0) & (pos < shape[a])
            keep = ok if keep is None else keep & ok
            idx.append(pos.clamp(0, shape[a] - 1).reshape([1] * nd))
        ti = tuple(idx)
        news = []
        for i, v in enumerate(d.values):
            if _is_undef(v):
                continue
            old = cur[i][ti]
            val = kastype(eval_array(v, ctx2), _ftype(func, i)).expand(vshape)
            if keep is not None:
                val = torch.where(keep, val, old)
            news.append((i, _unaliased(val, cur[i])))
        for i, val in news:
            cur[i].index_put_(ti, val.to(cur[i].dtype))
    return cur

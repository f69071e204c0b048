"""Array evaluation of the Expr IR in torch (counterpart of the JAX
package's eval_jnp).

A definition's scalar Expr is evaluated *whole-array* over an index grid into
torch tensors, on whatever device the realizations live on. The analog of the
reference's lowering for the default (unscheduled) pipeline: loop nests become
array axes.

- affine index tracking (`AVal`): producer accesses that are affine in the loop
  vars become slices, never gathers;
- `clamp(affine, lo, hi)` accesses become edge-pad + slice (the `repeat_edge`
  fast path);
- any other access is a gather with indices clipped into the buffer.

Axis convention: pipeline dim i of a func is tensor axis (ndim-1-i) of its
realized tensor; within an evaluation context, axes are addressed by `rpos`
(0 == minor axis).

Types: values are tensors in the compute dtype of their Type
(htypes.compute_dtype): u16 is computed in int32 and u32 in int64, masked back
into range after every op that can leave it; u64 is held in int64 as the same
bits, and compare, min, max, division, right shift and conversion to and from
float read them as unsigned. Integer `/` and `%` are floor division and floor
modulo with x/0 == x%0 == 0 (the reference's semantics); float `%` is
a - b*floor(a/b).

`print`, `print_when` and `require` read their values back to the host (a
wait for the card, in the pipelines that use them only) and go through the
port's `hooks`; `random` draws JAX's threefry2x32 bits, computed in torch.

Inline reductions (`_eval_reduce`) reduce over RDom axes added to the grid;
a sum of a product of two Func reads shaped as a convolution goes to
torch's convolution, any other sum of a product over a large grid to
torch.einsum (integers: a chunked multiply and sum), both as the JAX
package's contraction paths (`try_conv_reduce`, `try_einsum_reduce`), f32
at full precision (`contract_precision`).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import math
import os
from typing import Dict, List, Optional, Tuple

import torch

from . import expr as E
from .expr import CompileError, Expr
from .htypes import Int, Type, compute_dtype, torch_dtype

# ---------------------------------------------------------------------------
# symbolic index forms
# ---------------------------------------------------------------------------


class AVal:
    """Affine integer value: const + sum(coeff * axis_var)."""
    __slots__ = ("coeffs", "const")

    def __init__(self, coeffs: Dict[str, int], const: int):
        self.coeffs = {k: v for k, v in coeffs.items() if v != 0}
        self.const = int(const)

    def is_const(self) -> bool:
        return not self.coeffs

    def single_var(self) -> Optional[str]:
        if len(self.coeffs) == 1:
            return next(iter(self.coeffs))
        return None

    def __repr__(self):
        terms = [f"{c}*{v}" for v, c in self.coeffs.items()]
        terms.append(str(self.const))
        return "aff(" + " + ".join(terms) + ")"


class ClampedAVal:
    """clamp(affine, lo, hi), kept symbolic so producer access can lower to
    edge-pad + slice. lo/hi are ints or +-inf."""
    __slots__ = ("aval", "lo", "hi")

    def __init__(self, aval: AVal, lo, hi):
        self.aval = aval
        self.lo = lo
        self.hi = hi


class DivAVal:
    """(var + c) // d with d > 0."""
    __slots__ = ("var", "const", "div")

    def __init__(self, var: str, const: int, div: int):
        self.var = var
        self.const = int(const)
        self.div = int(div)


_INDEX_FORMS = (AVal, ClampedAVal, DivAVal)


class Axis:
    __slots__ = ("name", "rpos", "min", "extent")

    def __init__(self, name: str, rpos: int, mn: int, extent: int):
        self.name = name
        self.rpos = rpos
        self.min = int(mn)
        self.extent = int(extent)


class Realized:
    """A materialized stage: tensors (axis order = reversed dims) + origin.
    Tensors hold the storage dtype of the stage's Type; reads convert what
    they read to the compute dtype."""
    __slots__ = ("arrays", "mins", "name")

    def __init__(self, arrays, mins, name=""):
        self.arrays = tuple(arrays)
        self.mins = tuple(int(m) for m in mins)
        self.name = name


class Ctx:
    """An evaluation context. `fold`: inline reductions fold point by point
    in RDom order, r.x innermost, with no contraction path (K1's plain
    version, which must sum in the kernel's order). `trace`: the
    pipeline's Trace, which records each print's value."""
    __slots__ = ("ndim", "axes", "bindings", "realizations", "params",
                 "device", "memo", "fold", "trace")

    def __init__(self, ndim: int, axes: Dict[str, Axis], bindings: dict,
                 realizations: Dict[int, Realized], params: dict,
                 device="cpu", fold: bool = False, trace=None):
        self.ndim = ndim
        self.axes = axes
        self.bindings = bindings
        self.realizations = realizations
        self.params = params
        self.device = torch.device(device)
        self.memo: dict = {}
        self.fold = fold
        self.trace = trace

    def with_bindings(self, bindings: dict) -> "Ctx":
        return Ctx(self.ndim, self.axes, bindings, self.realizations,
                   self.params, self.device, self.fold, self.trace)

    def extended(self, new_axes: List[Axis]) -> "Ctx":
        """This context with `new_axes` (an update's rdom axes) added, so
        that RVar names resolve to array axes."""
        axes = dict(self.axes)
        for a in new_axes:
            axes[a.name] = a
        ndim = max([self.ndim] + [a.rpos + 1 for a in new_axes])
        return Ctx(ndim, axes, self.bindings, self.realizations, self.params,
                   self.device, self.fold, self.trace)


def _shape_at(ctx_ndim: int, rpos: int, extent: int) -> Tuple[int, ...]:
    s = [1] * ctx_ndim
    s[ctx_ndim - 1 - rpos] = extent
    return tuple(s)


def axis_array(ax: Axis, ctx: Ctx) -> torch.Tensor:
    a = torch.arange(ax.min, ax.min + ax.extent, dtype=torch.int32,
                     device=ctx.device)
    return a.reshape(_shape_at(ctx.ndim, ax.rpos, ax.extent))


def materialize(v, ctx: Ctx):
    """AVal/ClampedAVal/DivAVal -> int32 tensor; tensors pass through."""
    if isinstance(v, DivAVal):
        ax = ctx.axes.get(v.var)
        if ax is None:
            raise CompileError(f"free variable {v.var} in evaluation")
        return torch.div(axis_array(ax, ctx) + v.const, v.div,
                         rounding_mode="floor")
    if isinstance(v, ClampedAVal):
        arr = materialize(v.aval, ctx)
        lo = None if v.lo == -math.inf else int(v.lo)
        hi = None if v.hi == math.inf else int(v.hi)
        return torch.clamp(arr, lo, hi) if (lo, hi) != (None, None) else arr
    if isinstance(v, AVal):
        out = None
        for name, c in v.coeffs.items():
            ax = ctx.axes.get(name)
            if ax is None:
                raise CompileError(f"free variable {name} in evaluation")
            t = axis_array(ax, ctx)
            t = t * c if c != 1 else t
            out = t if out is None else out + t
        if out is None:
            return torch.full((), v.const, dtype=torch.int32,
                              device=ctx.device)
        return out + v.const if v.const else out
    return v


def full_shape(ctx: Ctx, axes: List[Axis]) -> Tuple[int, ...]:
    s = [1] * ctx.ndim
    for a in axes:
        s[ctx.ndim - 1 - a.rpos] = a.extent
    return tuple(s)


# ---------------------------------------------------------------------------
# wrapping of the types computed in a wider dtype
# ---------------------------------------------------------------------------

def _wrap(v: torch.Tensor, t: Type) -> torch.Tensor:
    """Bring a value back into the range of Type t. Only u16 and u32 need it:
    every other integer Type computes in its own dtype, which wraps."""
    if t.is_uint() and t.bits in (16, 32) and not t.is_bool():
        return v & ((1 << t.bits) - 1)
    return v


def to_compute(v: torch.Tensor, t: Type) -> torch.Tensor:
    """A tensor of storage dtype (or any dtype holding values of t) -> the
    compute dtype of t."""
    return v.to(compute_dtype(t))


# ---------------------------------------------------------------------------
# u64 held in int64: the operations that read the bits as unsigned
# ---------------------------------------------------------------------------

_SIGN64 = -(1 << 63)


def _is_u64(t: Type) -> bool:
    return t.is_uint() and t.bits == 64


def _uflip(v: torch.Tensor) -> torch.Tensor:
    """u64 order as int64 order: the sign bit flipped."""
    return v ^ _SIGN64


def _lshr64(a: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of int64 `a` by `s` in [0, 63] (an int, or a
    tensor: its mask is made on the card, not copied from the host)."""
    if isinstance(s, int):
        return (a >> s) & ((1 << (64 - s)) - 1) if s else a
    high = torch.bitwise_left_shift(torch.full_like(a, -1), 63 - s) << 1
    return (a >> s) & ~high


def _udivmod64(a: torch.Tensor, b: torch.Tensor):
    """Unsigned quotient and remainder of u64 values held in int64, b != 0:
    (a >>> 1) // b, doubled, is at most one short of the quotient (a
    divisor of 2^63 or more gives 0 or 1)."""
    big = b < 0
    bs = torch.where(big, torch.ones_like(b), b)
    q = torch.div(_lshr64(a, 1), bs, rounding_mode="floor") << 1
    q = q + (_uflip(a - q * bs) >= _uflip(bs)).to(torch.int64)
    q = torch.where(big, (_uflip(a) >= _uflip(b)).to(torch.int64), q)
    return q, a - q * b


def _u64_to_float(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """u64 (int64-held) -> float, rounded once: a value of 2^63 or more is
    halved with its low bit kept as a sticky bit, converted and doubled."""
    half = _lshr64(v, 1) | (v & 1)
    return torch.where(v < 0, half.to(dtype) * 2, v.to(dtype))


def _float_to_u64(v: torch.Tensor) -> torch.Tensor:
    """float -> u64 as XLA converts it: truncated toward zero, NaN and
    values below 0 giving 0, values of 2^64 or more giving 2^64 - 1."""
    v = torch.where(torch.isnan(v) | (v < 0), torch.zeros_like(v), v)
    big = v >= 2.0 ** 63
    # below 2^63 in f32 and f64 alike (2^64 and up is replaced below)
    r = torch.where(big, v - 2.0 ** 63, v).clamp(
        max=2.0 ** 63 - 2.0 ** 40).to(torch.int64)
    r = torch.where(big, r ^ _SIGN64, r)
    return torch.where(v >= 2.0 ** 64, torch.full_like(r, -1), r)


def cast_value(v: torch.Tensor, src: Type, dst: Type) -> torch.Tensor:
    """Halide cast semantics on compute-dtype tensors: integer narrowing
    wraps, float -> int truncates toward zero, anything -> bool is != 0.
    u64 converts to and from float as XLA does (`_float_to_u64`)."""
    if dst.is_bool():
        return v != 0
    if v.dtype == torch.bool:
        v = v.to(torch.int32)
    if dst.is_float():
        if _is_u64(src):
            return _u64_to_float(v, compute_dtype(dst))
        return v.to(compute_dtype(dst))
    if src.is_float():
        if _is_u64(dst):
            return _float_to_u64(v)
        v = v.to(torch.int64)        # truncate toward zero, then wrap
    if dst.is_uint() and dst.bits < 64:
        return (v.to(torch.int64) & ((1 << dst.bits) - 1)) \
            .to(compute_dtype(dst))
    return v.to(compute_dtype(dst))


def reinterpret(v: torch.Tensor, src: Type, dst: Type) -> torch.Tensor:
    """The bits of a compute-dtype value of Type src read as Type dst (the
    same width): through the storage dtypes, never a wider compute dtype."""
    return to_compute(v.to(torch_dtype(src)).view(torch_dtype(dst)), dst)


def kastype(v: torch.Tensor, t: Type) -> torch.Tensor:
    """A value tensor (any compute dtype) -> the compute dtype of Type t,
    with Halide cast semantics (the JAX package's `_kastype`, whose kernel
    special cases have no counterpart here; its `_kwhere` has only such
    cases, so its counterpart is torch.where)."""
    src = Type("float", 32) if v.is_floating_point() else Int(64)
    return cast_value(v, src, t)


# ---------------------------------------------------------------------------
# the evaluator
# ---------------------------------------------------------------------------

_MATH1 = {
    "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
    "floor": torch.floor, "ceil": torch.ceil, "trunc": torch.trunc,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
    "rsqrt": torch.rsqrt, "erf": torch.erf,
    # reference round: round-half-to-even, as torch.round
    "round": torch.round,
}


def evaluate(e: Expr, ctx: Ctx):
    key = id(e)
    hit = ctx.memo.get(key)
    if hit is not None:
        return hit[0]
    r = _eval(e, ctx)
    ctx.memo[key] = (r, e)
    return r


def eval_array(e: Expr, ctx: Ctx) -> torch.Tensor:
    return materialize(evaluate(e, ctx), ctx)


def _const(value, t: Type, ctx: Ctx) -> torch.Tensor:
    # torch.full, not torch.tensor: on the card, torch.tensor copies from
    # the host and waits for every kernel queued before it
    if _is_u64(t) and value >= 1 << 63:
        value -= 1 << 64                 # the same bits in int64
    return torch.full((), value, dtype=compute_dtype(t), device=ctx.device)


def _eval(e: Expr, ctx: Ctx):
    if isinstance(e, E.IntImm):
        if e.dtype == Int(32):
            return AVal({}, e.value)
        if e.dtype.is_bool():
            return torch.full((), bool(e.value), device=ctx.device)
        return _const(e.value, e.dtype, ctx)
    if isinstance(e, E.FloatImm):
        return _const(e.value, e.dtype, ctx)
    if isinstance(e, E.Variable):
        if e.name in ctx.bindings:
            return ctx.bindings[e.name]
        if e.name in ctx.axes:
            return AVal({e.name: 1}, 0)
        raise CompileError(f"undefined variable {e.name!r} in evaluation")
    if isinstance(e, E.Cast):
        v = evaluate(e.value, ctx)
        if e.dtype == e.value.dtype:
            return v
        if isinstance(v, _INDEX_FORMS):
            if e.dtype in (Int(32), Int(64)):
                return v     # index arithmetic is exact; keep affine form
            v = materialize(v, ctx)
        return cast_value(v, e.value.dtype, e.dtype)
    if isinstance(e, E.Reinterpret):
        return reinterpret(eval_array(e.value, ctx), e.value.dtype, e.dtype)
    if isinstance(e, E.Binary):
        return _eval_binary(e, ctx)
    if isinstance(e, E.Not):
        return torch.logical_not(eval_array(e.a, ctx))
    if isinstance(e, E.Select):
        c = eval_array(e.cond, ctx)
        t = eval_array(e.true_value, ctx)
        f = eval_array(e.false_value, ctx)
        return torch.where(c, t, f)
    if isinstance(e, E.Call):
        return _eval_call(e, ctx)
    if isinstance(e, E.Intrin):
        return _eval_intrin(e, ctx)
    if isinstance(e, E.Let):
        v = evaluate(e.value, ctx)
        child = ctx.with_bindings({**ctx.bindings, e.name: v})
        return evaluate(e.body, child)
    if isinstance(e, E.Reduce):
        return _eval_reduce(e, ctx)
    if isinstance(e, E.StringImm):
        return e.value
    raise CompileError(f"cannot evaluate {type(e).__name__}")


def _aval_binary(op, a, b):
    """Affine-preserving binary ops on Int(32)/Int(64) values; returns None
    if the result must materialize."""
    if isinstance(a, AVal) and isinstance(b, AVal) and a.is_const() \
            and b.is_const():
        xv, yv = a.const, b.const
        folds = {
            "div": lambda: 0 if yv == 0 else xv // yv,
            "mod": lambda: 0 if yv == 0 else xv % yv,
            "min": lambda: min(xv, yv), "max": lambda: max(xv, yv),
            "bitand": lambda: xv & yv, "bitor": lambda: xv | yv,
            "bitxor": lambda: xv ^ yv,
        }
        if op in ("shl", "shr") and yv >= 0:
            return AVal({}, xv << yv if op == "shl" else xv >> yv)
        if op in folds:
            return AVal({}, folds[op]())
    if op in ("add", "sub") and isinstance(a, AVal) and isinstance(b, AVal):
        sign = 1 if op == "add" else -1
        c = dict(a.coeffs)
        for k, v in b.coeffs.items():
            c[k] = c.get(k, 0) + sign * v
        return AVal(c, a.const + sign * b.const)
    if op == "mul" and isinstance(a, AVal) and isinstance(b, AVal):
        if a.is_const():
            a, b = b, a
        if b.is_const():
            return AVal({k: v * b.const for k, v in a.coeffs.items()},
                        a.const * b.const)
    if op in ("min", "max"):
        # clamp patterns: max(min(aff, hi), lo) stays symbolic
        def as_clamped(x):
            if isinstance(x, AVal):
                return ClampedAVal(x, -math.inf, math.inf)
            return x if isinstance(x, ClampedAVal) else None

        for x, k in ((a, b), (b, a)):
            cx = as_clamped(x)
            if cx is not None and isinstance(k, AVal) and k.is_const():
                if op == "min":
                    return ClampedAVal(cx.aval, cx.lo, min(cx.hi, k.const))
                return ClampedAVal(cx.aval, max(cx.lo, k.const), cx.hi)
    if op == "div" and isinstance(a, AVal) and isinstance(b, AVal) \
            and b.is_const() and b.const != 0:
        d = b.const
        if all(v % d == 0 for v in a.coeffs.values()) and a.const % d == 0:
            return AVal({k: v // d for k, v in a.coeffs.items()},
                        a.const // d)
        sv = a.single_var()
        if sv is not None and a.coeffs[sv] == 1 and d > 1:
            return DivAVal(sv, a.const, d)
    if op in ("add", "sub") and isinstance(a, DivAVal) \
            and isinstance(b, AVal) and b.is_const():
        # (x + c)//d +- e == (x + c +- e*d)//d exactly
        e2 = b.const if op == "add" else -b.const
        return DivAVal(a.var, a.const + e2 * a.div, a.div)
    if op == "add" and isinstance(b, DivAVal) and isinstance(a, AVal) \
            and a.is_const():
        return DivAVal(b.var, b.const + a.const * b.div, b.div)
    return None


def _eval_binary(e: E.Binary, ctx: Ctx):
    a = evaluate(e.a, ctx)
    b = evaluate(e.b, ctx)
    if e.dtype.is_int() and e.dtype.bits in (32, 64):
        r = _aval_binary(e.op, a, b)
        if r is not None:
            return r
    return _apply_binop(e.op, e.a.dtype, materialize(a, ctx),
                        materialize(b, ctx))


def _int_divmod(am, bm, t: Type, mode: str):
    """Integer quotient and remainder, rounded `mode` ("floor" or "trunc"),
    with x/0 == x%0 == 0 and the signed minimum over -1 wrapping to itself
    (remainder 0), as XLA gives: the CPU's division traps there."""
    bz = bm == 0
    if _is_u64(t):
        q, r = _udivmod64(am, torch.where(bz, torch.ones_like(bm), bm))
    else:
        neg1 = (bm == -1) if t.is_int() else torch.zeros_like(bz)
        safe = torch.where(bz | neg1, torch.ones_like(bm), bm)
        q = torch.div(am, safe, rounding_mode=mode)
        r = torch.remainder(am, safe) if mode == "floor" else \
            torch.fmod(am, safe)
        q = torch.where(neg1, _wrap(-am, t), q)
        r = torch.where(neg1, torch.zeros_like(r), r)
    return (torch.where(bz, torch.zeros_like(q), q),
            torch.where(bz, torch.zeros_like(r), r))


def _apply_binop(op: str, t: Type, am, bm):
    """One binary op on compute-dtype tensors of Type t (the operands'
    type; comparisons return bool)."""
    if op == "add":
        return _wrap(am + bm, t)
    if op == "sub":
        return _wrap(am - bm, t)
    if op == "mul":
        return _wrap(am * bm, t)
    if op in ("div", "mod"):
        if t.is_float():
            return am / bm if op == "div" else am - bm * torch.floor(am / bm)
        q, r = _int_divmod(am, bm, t, "floor")
        return q if op == "div" else r
    cmp = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
           "gt": torch.gt, "ge": torch.ge}
    if _is_u64(t) and op in ("min", "max", "lt", "le", "gt", "ge"):
        lt = _uflip(am) < _uflip(bm)
        if op in ("min", "max"):
            return torch.where(lt == (op == "min"), am, bm)
        return cmp[op](_uflip(am), _uflip(bm))
    if op == "min":
        return torch.minimum(am, bm)
    if op == "max":
        return torch.maximum(am, bm)
    if op in cmp:
        return cmp[op](am, bm)
    if op == "and":
        return torch.logical_and(am, bm)
    if op == "or":
        return torch.logical_or(am, bm)
    if _is_u64(t) and op in ("shl", "shr"):
        # a count of 64 or more (or 2^63 and up, negative in int64) gives 0
        bm = bm.to(am.dtype)
        out = (bm < 0) | (bm >= 64)
        s = torch.where(out, torch.zeros_like(bm), bm)
        r = am << s if op == "shl" else _lshr64(am, s)
        return torch.where(out, torch.zeros_like(r), r)
    if op == "shl":
        return _wrap(torch.bitwise_left_shift(am, bm.to(am.dtype)), t)
    if op == "shr":
        return torch.bitwise_right_shift(am, bm.to(am.dtype))
    if op == "bitand":
        return torch.bitwise_and(am, bm)
    if op == "bitor":
        return torch.bitwise_or(am, bm)
    if op == "bitxor":
        return torch.bitwise_xor(am, bm)
    raise CompileError(f"unknown binary op {op}")


# ---------------------------------------------------------------------------
# producer access: slice / edge-pad + slice for clamps / gather fallback
# ---------------------------------------------------------------------------

def _eval_call(e: E.Call, ctx: Ctx):
    from .func import Func
    target = e.target
    real = ctx.realizations.get(id(target))
    if real is None:
        if isinstance(target, Func):
            # inline: bind args, evaluate the body
            if not target.defined():
                raise CompileError(f"Func {target.name} is undefined")
            vals = [evaluate(a, ctx) for a in e.args]
            names = [v.name for v in target.args()]
            child = ctx.with_bindings(dict(zip(names, vals)))
            return evaluate(target._defs[0].values[e.value_index], child)
        raise CompileError(
            f"no data bound for {getattr(target, 'name', target)}")
    P = real.arrays[e.value_index]
    args = [evaluate(a, ctx) for a in e.args]
    used = []
    for v in args:
        if isinstance(v, DivAVal):
            used.append(v.var)
            continue
        av = v.aval if isinstance(v, ClampedAVal) else v
        if not isinstance(av, AVal) or len(av.coeffs) > 1:
            return _gather_read(P, real, e.dtype, args, ctx)
        used.extend(av.coeffs)
    if len(set(used)) != len(used):
        return _gather_read(P, real, e.dtype, args, ctx)   # diagonal access
    return _slice_read(P, real, e.dtype, args, ctx)


def _slice_read(P, real: Realized, t: Type, args, ctx: Ctx):
    """Affine (possibly clamped) or div-indexed access with one var per dim,
    as slices. Along each affine dim the read positions are clamp(u(x), lo,
    hi) for the raw affine positions u(x), then edge-replicated into the
    realization (a clamp whose bounds exceed the realized region reads the
    edge, as the reference's edge-pad does). A unit-stride span inside both
    stays a view, and so does a stride c > 1 whose reads all lie inside
    them (a strided slice, as the reference's strided lax.slice); any other
    affine dim (a negative coefficient, a clamp or edge that bites) is one
    index_select over the converted window. A div-indexed dim, (x + c) //
    d, is the span of positions it reads, each repeated d times, from the
    phase of x's first value on; one that leaves the realization is
    gathered (clipped into it), as before."""
    nd = P.ndim
    out_axes: List[Optional[Axis]] = []
    spans, picks = [], []
    for j, v in enumerate(args):          # j = pipeline dim
        npax = nd - 1 - j
        if isinstance(v, DivAVal):
            ax_out = ctx.axes.get(v.var)
            if ax_out is None:
                return _gather_read(P, real, t, args, ctx)
            first = ax_out.min + v.const
            u_lo = first // v.div
            u_hi = (first + ax_out.extent - 1) // v.div
            a = u_lo - real.mins[j]
            if a < 0 or u_hi - real.mins[j] >= P.shape[npax]:
                return _gather_read(P, real, t, args, ctx)
            spans.append((npax, a, u_hi - u_lo + 1))
            picks.append((v.div, first - u_lo * v.div, ax_out.extent))
            out_axes.append(ax_out)
            continue
        lo_clip, hi_clip = -math.inf, math.inf
        clamped = isinstance(v, ClampedAVal)
        if clamped:
            lo_clip, hi_clip = v.lo, v.hi
            v = v.aval
        sv = v.single_var()
        if sv is None:
            ax_out, c, u0, ext = None, 0, v.const, 1
        else:
            ax_out = ctx.axes[sv]
            c = v.coeffs[sv]
            u0, ext = v.const + c * ax_out.min, ax_out.extent
        u_lo, u_hi = (u0, u0 + c * (ext - 1)) if c >= 0 \
            else (u0 + c * (ext - 1), u0)
        size, rmin = P.shape[npax], real.mins[j]
        if not clamped and sv is not None and (u_lo < rmin
                                               or u_hi > rmin + size - 1):
            raise CompileError(
                f"access to {real.name} out of realized bounds on dim {j}: "
                f"[{u_lo}, {u_hi}] vs min {rmin} extent {size}")

        def pos(u):          # clamp, then replicate the realized edge
            return min(max(int(min(max(u, lo_clip), hi_clip)) - rmin, 0),
                       size - 1)

        a, b = pos(u_lo), pos(u_hi)
        spans.append((npax, a, b - a + 1))
        if c in (0, 1) and b - a + 1 == ext:
            picks.append(None)                       # a plain view
        elif c > 1 and b - a == c * (ext - 1):
            picks.append(slice(None, None, c))       # a strided view
        else:
            u = torch.arange(ext, device=P.device) * c + u0
            if clamped:
                u = u.clamp(None if lo_clip == -math.inf else int(lo_clip),
                            None if hi_clip == math.inf else int(hi_clip))
            picks.append((u - rmin).clamp(0, size - 1) - a)
        out_axes.append(ax_out)
    Q = P
    for (npax, lo, n), pick in zip(spans, picks):
        Q = Q.narrow(npax, lo, n)
        if isinstance(pick, slice):
            Q = Q[(slice(None),) * npax + (pick,)]
    Q = to_compute(Q, t)
    for (npax, _lo, n), pick in zip(spans, picks):
        if isinstance(pick, tuple):
            d, phase, ext = pick
            shp = list(Q.shape)
            Q = Q.unsqueeze(npax + 1).expand(
                shp[:npax + 1] + [d] + shp[npax + 1:]).reshape(
                shp[:npax] + [n * d] + shp[npax + 1:]).narrow(npax, phase,
                                                              ext)
        elif isinstance(pick, torch.Tensor):
            Q = Q.index_select(npax, pick)
    # place the kept axes at their context positions
    kept = sorted((ctx.ndim - 1 - ax.rpos, nd - 1 - j)
                  for j, ax in enumerate(out_axes) if ax is not None)
    Q = Q.permute([s for _, s in kept]
                  + [a for a in range(nd) if a not in {s for _, s in kept}])
    newshape = [1] * ctx.ndim
    for k, (dst, _src) in enumerate(kept):
        newshape[dst] = Q.shape[k]
    return Q.reshape(newshape)


def _gather_read(P, real: Realized, t: Type, args, ctx: Ctx):
    nd = P.ndim
    idxs = []
    for j, v in enumerate(args):
        arr = materialize(v, ctx).to(torch.int64) - real.mins[j]
        # ClampUnsafeAccesses analog: indices clip into the buffer
        idxs.append(arr.clamp(0, P.shape[nd - 1 - j] - 1))
    # torch cannot index uint16/32/64 tensors: index in the compute dtype
    # (the whole realization: narrowing it to the indices' span would read
    # their range back to the host, a wait for the card)
    shaped = torch.broadcast_tensors(*reversed(idxs))
    return to_compute(P, t)[tuple(shaped)]


def edge_window(P, t: Type, mins, lohi) -> torch.Tensor:
    """The window lohi = [(lo, extent)] per pipeline dim of a realization P
    (storage dtype, origin `mins`), edge-replicated where it leaves P, in
    P's dtype: P[clamp(lo + i - min)] along every dim."""
    nd = P.ndim
    picks = []
    for j, (lo, ext) in enumerate(lohi):
        size = P.shape[nd - 1 - j]
        idx = [min(max(lo + i - mins[j], 0), size - 1) for i in range(ext)]
        a = idx[0] if ext else 0
        P = P.narrow(nd - 1 - j, a, idx[-1] - a + 1)
        picks.append([i - a for i in idx])
    Q = to_compute(P, t)
    for j, pick in enumerate(picks):
        if pick != list(range(len(pick))):
            Q = Q.index_select(nd - 1 - j, torch.tensor(pick,
                                                        device=Q.device))
    return Q.to(P.dtype)


# ---------------------------------------------------------------------------
# intrinsics
# ---------------------------------------------------------------------------

def _eval_intrin(e: E.Intrin, ctx: Ctx):
    n = e.name
    if n in _MATH1:
        return _MATH1[n](eval_array(e.args[0], ctx))
    if n == "pow":
        a = eval_array(e.args[0], ctx)
        if pow_is_square(e):
            return a * a
        return torch.pow(a, eval_array(e.args[1], ctx))
    if n == "atan2":
        return torch.atan2(eval_array(e.args[0], ctx),
                           eval_array(e.args[1], ctx))
    if n == "abs":
        r = eval_array(e.args[0], ctx)
        r = r if e.args[0].dtype.is_uint() else torch.abs(r)
        return cast_value(r, e.args[0].dtype, e.dtype) \
            if e.dtype != e.args[0].dtype else r
    if n == "absd":
        a = eval_array(e.args[0], ctx)
        b = eval_array(e.args[1], ctx)
        r = torch.where(_apply_binop("gt", e.args[0].dtype, a, b), a - b,
                        b - a)
        return cast_value(r, e.args[0].dtype, e.dtype) \
            if e.dtype != e.args[0].dtype else r
    if n in ("likely", "strict_float"):
        return evaluate(e.args[0], ctx)
    if n == "is_nan":
        return torch.isnan(eval_array(e.args[0], ctx))
    if n == "is_inf":
        return torch.isinf(eval_array(e.args[0], ctx))
    if n == "is_finite":
        return torch.isfinite(eval_array(e.args[0], ctx))
    if n == "bitnot":
        return _wrap(torch.bitwise_not(eval_array(e.args[0], ctx)), e.dtype)
    if n == "param":
        p = e.args[0]
        if id(p) not in ctx.params:
            raise CompileError(f"Param {p.name} is unset")
        v = ctx.params[id(p)]
        if isinstance(v, torch.Tensor):
            # a traced value (derivative.propagate_adjoints): kept in the
            # graph, not read to the host
            return v.to(device=ctx.device, dtype=compute_dtype(e.dtype))
        return _const(v, e.dtype, ctx)
    if n in ("buffer_min", "buffer_extent"):
        img, i = e.args
        real = ctx.realizations.get(id(img))
        if real is None:
            raise CompileError(f"ImageParam {img.name} is unbound")
        if n == "buffer_min":
            return AVal({}, real.mins[i])
        return AVal({}, real.arrays[0].shape[real.arrays[0].ndim - 1 - i])
    if n == "lerp":
        return _lerp(eval_array(e.args[0], ctx), eval_array(e.args[1], ctx),
                     eval_array(e.args[2], ctx), e.dtype, e.args[2].dtype)
    if n == "saturating_cast":
        return saturating_cast(eval_array(e.args[0], ctx), e.args[0].dtype,
                               e.dtype)
    if n == "recip":
        return 1.0 / eval_array(e.args[0], ctx)
    if n in ("popcount", "clz", "ctz"):
        t = e.args[0].dtype
        u = _unsigned_bits(eval_array(e.args[0], ctx), t)
        if n == "popcount":
            r = _popcount(u)
        elif n == "clz":
            r = t.bits - _bit_length(u, t.bits)
        else:
            r = torch.where(u == 0, t.bits,
                            _bit_length(u & -u, t.bits) - 1)
        return r.to(compute_dtype(e.dtype))
    if n in ("div_rtz", "mod_rtz"):
        a = eval_array(e.args[0], ctx)
        b = eval_array(e.args[1], ctx)
        t = e.args[0].dtype
        if t.is_float():
            bz = b == 0
            safe = torch.where(bz, torch.ones_like(b), b)
            r = a / safe if n == "div_rtz" else torch.fmod(a, safe)
            return torch.where(bz, torch.zeros_like(r), r)
        q, r = _int_divmod(a, b, t, "trunc")
        return q if n == "div_rtz" else r
    if n == "random":
        return _random(e, ctx)
    if n == "require":
        return _require(e, ctx)
    if n in ("print", "print_when"):
        return _print(e, ctx)
    if n == "undef":
        raise CompileError("undef() may only appear as a whole update value")
    raise CompileError(f"unimplemented intrinsic {n!r}")


# ---------------------------------------------------------------------------
# bit counts, integer operations only (torch has no clz or popcount)
# ---------------------------------------------------------------------------

def pow_is_square(e: E.Intrin) -> bool:
    """pow(x, 2.0), an exponent that is the constant 2: computed as x * x,
    as XLA's simplifier computes it (the JAX package realizes under jit)
    and torch's pow with a Python scalar 2; the group kernel does the
    same."""
    b = e.args[1]
    return isinstance(b, E.FloatImm) and b.value == 2.0


def _unsigned_bits(v: torch.Tensor, t: Type) -> torch.Tensor:
    """The bits of an integer value of Type t in int64: t's bits, zero-
    extended (a 64-bit Type's are the int64 itself)."""
    v = v.to(torch.int64)
    return v & ((1 << t.bits) - 1) if t.bits < 64 else v


def _popcount(u: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64, by SWAR: pairs, nibbles, bytes, then the
    bytes summed into the top one by a multiply."""
    u = u - ((u >> 1) & 0x5555555555555555)
    u = (u & 0x3333333333333333) + ((u >> 2) & 0x3333333333333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (u * 0x0101010101010101) >> 56


def _bit_length(u: torch.Tensor, bits: int) -> torch.Tensor:
    """Bits each value of a `bits`-bit unsigned Type (`_unsigned_bits`)
    needs: a binary search over halves, 0 for 0."""
    n = torch.zeros_like(u)
    s = bits // 2
    while s:
        hi = _lshr64(u, s) if bits == 64 else u >> s
        m = hi != 0
        n = n + m.to(torch.int64) * s
        u = torch.where(m, hi, u)
        s //= 2
    return n + (u != 0).to(torch.int64)


# ---------------------------------------------------------------------------
# random: the JAX package's draw (jax.random with threefry2x32 keys and
# jax_threefry_partitionable), in uint32 arithmetic held in int64
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of JAX (`jax._src.prng`): 20 rounds, the key
    injected after every 4. uint32 values held in int64 tensors (or ints);
    -> the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1, x2 = (x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = x1 ^ (((x2 << r) | (x2 >> (32 - r))) & _M32)
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def _random(e: E.Intrin, ctx: Ctx) -> torch.Tensor:
    """random_float / random_uint / random_int over the evaluated shape:
    the key is jax.random.key(tag * 2654435761 % 2^31), i.e. (0, that),
    folded (`fold_in`: the hash of the key at the counter (0, data)) with
    the first element of the seed argument where there is one; then
    jax.random.bits (the hash at the 64-bit row-major index of each
    element, its two words xor'ed) or jax.random.uniform (the top 23 bits
    as the mantissa of a float in [1, 2), minus 1)."""
    dev = ctx.device
    tag = int(e.args[-1])
    k1 = torch.zeros((), dtype=torch.int64, device=dev)
    k2 = torch.full((), tag * 2654435761 % (1 << 31), dtype=torch.int64,
                    device=dev)
    if len(e.args) > 1:
        sd = eval_array(e.args[0], ctx).reshape(-1)[0]
        data = sd.to(torch.int64) & _M32
        k1, k2 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    shape = full_shape(ctx, list(ctx.axes.values()))
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=dev).reshape(shape)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    bits = b1 ^ b2
    if e.dtype.is_float():
        one = (bits >> 9) | 0x3F800000
        return one.to(torch.int32).view(torch.float32) - 1.0
    return cast_value(bits, Int(64), e.dtype)


# ---------------------------------------------------------------------------
# print, print_when and require: through the port's hooks, once per
# realization; the values are read back to the host
# ---------------------------------------------------------------------------

def _host(v: torch.Tensor, t: Type):
    """A compute-dtype value of Type t, in t's storage dtype on the host."""
    from .hooks import to_numpy
    return to_numpy(v.to(torch_dtype(t)))


def _print(e: E.Intrin, ctx: Ctx):
    """print: the value passes through, and its summary with the string
    arguments goes through hooks.halide_print; print_when prints the
    values where the condition holds, where it holds anywhere. Under a
    trace, each print also records its value (`Trace.emit_print`)."""
    from . import hooks
    idx = 0 if e.name == "print" else 1
    val = evaluate(e.args[idx], ctx)
    vn = _host(materialize(val, ctx), e.args[idx].dtype)
    if ctx.trace is not None:
        ctx.trace.emit_print(vn)
    if e.name == "print":
        strs = [a.value if isinstance(a, E.StringImm) else a
                for a in e.args[1:] if isinstance(a, (E.StringImm, str))]
        hooks.halide_print(" ".join([hooks.format_value(vn)] + strs) + "\n")
        return val
    cn = _host(eval_array(e.args[0], ctx), e.args[0].dtype).astype(bool)
    if cn.any():
        sel = vn[cn] if vn.shape == cn.shape else vn.reshape(-1)
        hooks.halide_print(hooks.format_value(sel) + "\n")
    return val


def _require(e: E.Intrin, ctx: Ctx):
    """require(cond, value, ...): the value passes through; a condition
    that fails anywhere goes through hooks.halide_error."""
    from . import hooks
    cn = _host(eval_array(e.args[0], ctx), e.args[0].dtype).astype(bool)
    val = evaluate(e.args[1], ctx)
    if not cn.all():
        bad = int((~cn).sum()) if cn.size > 1 else 1
        hooks.halide_error(f"Requirement Failed: ({bad} of "
                           f"{max(cn.size, 1)} lanes violate the condition)")
    return val


def saturating_cast(v: torch.Tensor, src: Type, t: Type) -> torch.Tensor:
    """The reference's saturating_cast (`eval_jnp.py` `saturating_cast`):
    float -> float is a plain cast; float -> integer clips to the target's
    range in the float type and truncates, NaN giving 0 (XLA's conversion),
    a bound that the float type rounds up (2^31 for i32 in f32) giving the
    target's maximum; integer -> integer clamps in int64, a u64 source
    (held in int64) read as unsigned. To or from 64 bits this is not the
    reference's: it clips 64-bit sources through int32 (ROADMAP, queue 3)."""
    if t.is_float():
        return cast_value(v, src, t)
    lo, hi = int(t.min_value()), int(t.max_value())
    if src.is_float() and _is_u64(t):
        return _float_to_u64(v)        # clips to [0, 2^64 - 1], NaN -> 0
    if _is_u64(src) or _is_u64(t):
        v = v.to(torch.int64)
        if _is_u64(src) and _is_u64(t):
            return v
        if _is_u64(t):
            return v.clamp(min=0)
        # 2^63 and up (negative in int64) lie above any other maximum
        return torch.where(v < 0, hi, v.clamp(max=hi)).to(compute_dtype(t))
    if src.is_float():
        v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
        v = v.clamp(float(lo), float(hi))
        if t.bits == 64:       # int64 cannot hold the rounded-up bound
            big = v >= float(hi)
            r = torch.where(big, torch.zeros_like(v), v).to(torch.int64)
            return torch.where(big, hi, r).to(compute_dtype(t))
    return v.to(torch.int64).clamp(lo, hi).to(compute_dtype(t))


def _lerp(zero, one, w, t: Type, wt: Type):
    """The reference's lerp: zero * (1 - w) + one * w (not zero + w *
    (one - zero)); a uint weight spans its range (w / (2^bits - 1)), a bool
    weight selects, and an integer result is computed in f32 and rounded
    half to even."""
    if wt.is_bool():
        return torch.where(w, one, zero)
    if wt.is_uint():
        w = w.to(torch.float32) / float((1 << wt.bits) - 1)
    if t.is_float():
        return zero * (1.0 - w) + one * w
    r = zero.to(torch.float32) * (1.0 - w) + one.to(torch.float32) * w
    return kastype(torch.round(r), t)


def static_int(e: Expr, ctx: Ctx) -> int:
    """Evaluate an expr that must be a plan-time constant (split factors,
    bound() arguments). Params and buffer dims resolve statically."""
    v = evaluate(e, ctx)
    if isinstance(v, AVal) and v.is_const():
        return v.const
    if isinstance(v, _INDEX_FORMS):
        raise CompileError(f"expected static value, got {v!r}")
    return int(v)


# ---------------------------------------------------------------------------
# inline reductions and the contraction paths
# ---------------------------------------------------------------------------

# how each inline reduction was evaluated (the chip check prints it):
# "conv", "einsum", "reduce" (torch's reductions), "fold" (K1's plain
# version, point by point)
reduce_paths: collections.Counter = collections.Counter()

# the einsum path needs a grid (output and RDom) of at least this many
# elements, as the JAX package's _EINSUM_MIN_FULL
_EINSUM_MIN_FULL = 1 << 22
_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
# elements of one chunk's product grid in an integer contraction
_INT_CHUNK = 1 << 24

_reduce_instance = [0]


def reduce_identity(op: str, t: Type):
    """The value a reduction of values of Type t starts from (the JAX
    package's `_reduce_identity`); argmax and argmin start from t's min and
    max."""
    if op == "sum":
        return 0
    if op == "product":
        return 1
    if op in ("maximum", "argmax"):
        return t.min_value()
    if op in ("minimum", "argmin"):
        return t.max_value()
    raise CompileError(f"unknown reduction {op}")


@contextlib.contextmanager
def contract_precision():
    """The JAX package's `_contract_precision` (HT_PRECISION=default|
    highest) on the card: f32 contractions at full precision, with TF32
    off in cuBLAS and cuDNN (cuDNN's convolutions take TF32 by default)
    and bf16 reductions at full precision, unless HT_PRECISION=default.
    The flags are set around the port's own contractions only and
    restored after: the process's settings stay the caller's."""
    if os.environ.get("HT_PRECISION", "").lower() == "default":
        yield
        return
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, dnn.allow_tf32,
             mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = dnn.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (mm.allow_tf32, dnn.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = saved


def _fit_ctx_shape(shape, ctx_ndim: int):
    if ctx_ndim == 0:
        return ()
    shape = list(shape)
    if len(shape) >= ctx_ndim:
        return tuple(shape[-ctx_ndim:])
    return tuple([1] * (ctx_ndim - len(shape)) + shape)


def _eval_reduce(e: E.Reduce, ctx: Ctx):
    """An inline reduction over its RDom (the JAX package's `_eval_reduce`).
    The RDom's axes get names unique to this evaluation and its RVars are
    bound to them, so one RDom reused in nested reductions cannot collide.
    An empty RDom gives the identity; predicates and `where` replace the
    points they exclude by the identity."""
    rd = e.rdom
    _reduce_instance[0] += 1
    tag = _reduce_instance[0]
    new_axes, binds = [], dict(ctx.bindings)
    for i, rv in enumerate(rd.dims):
        fresh = f"{rv.name}#{tag}"
        new_axes.append(Axis(fresh, ctx.ndim + i, static_int(rv.rmin, ctx),
                             static_int(rv.rextent, ctx)))
        binds[rv.name] = AVal({fresh: 1}, 0)
    vt = e.value.dtype
    if any(a.extent <= 0 for a in new_axes):
        if e.op in ("argmin", "argmax"):
            raise CompileError(f"{e.op} over an empty RDom")
        return _const(reduce_identity(e.op, vt), vt, ctx)
    inner = ctx.extended(new_axes)
    inner.bindings = binds
    red = tuple(inner.ndim - 1 - a.rpos for a in new_axes)
    preds = list(rd.predicates) + ([e.where] if e.where is not None else [])
    if e.op == "sum" and not preds and not ctx.fold:
        try:
            r, path = try_conv_reduce(e.value, inner,
                                      [a.name for a in new_axes]), "conv"
        except CompileError:
            r = None
        if r is None:
            r, path = try_einsum_reduce(e.value, inner, red), "einsum"
        if r is not None:
            reduce_paths[path] += 1
            return r.reshape(_fit_ctx_shape(r.shape, ctx.ndim))
    val = eval_array(e.value, inner)
    val = val.expand(torch.broadcast_shapes(val.shape,
                                            full_shape(inner, new_axes)))
    mask = None
    for p in preds:
        pm = eval_array(p, inner)
        mask = pm if mask is None else torch.logical_and(mask, pm)
    if mask is not None:
        val = torch.where(mask, val,
                          _const(reduce_identity(e.op, vt), vt, inner))
    if e.op in ("argmin", "argmax"):
        out = _arg_reduce(e, val, new_axes, red)
    elif ctx.fold:
        reduce_paths["fold"] += 1
        out = _fold_reduce(e.op, vt, val, new_axes, inner)
    else:
        reduce_paths["reduce"] += 1
        out = _torch_reduce(e.op, vt, val, red)
    return out.reshape(_fit_ctx_shape(out.shape, ctx.ndim))


_COMBINE = {"sum": "add", "product": "mul", "maximum": "max",
            "minimum": "min"}


def _torch_reduce(op: str, t: Type, val: torch.Tensor, red) -> torch.Tensor:
    """sum, product, maximum or minimum over the axes `red` (kept), in the
    Type t: torch sums and multiplies integers in int64, which the cast
    back wraps as the Type's own arithmetic would; u64 (in int64) is
    ordered as unsigned."""
    if op in ("sum", "product"):
        if op == "sum":
            r = torch.sum(val, dim=red, keepdim=True)
        else:
            r = val
            for a in red:
                r = torch.prod(r, dim=a, keepdim=True)
        return r if val.is_floating_point() else \
            cast_value(r, Int(64), t)
    fn = torch.amax if op == "maximum" else torch.amin
    if _is_u64(t):
        return _uflip(fn(_uflip(val), dim=red, keepdim=True))
    return fn(val, dim=red, keepdim=True)


def _fold_reduce(op: str, t: Type, val: torch.Tensor, axes: List[Axis],
                 ctx: Ctx) -> torch.Tensor:
    """The reduction folded point by point from the identity, r.x
    innermost (K1's loop order), each step the Type's own operation."""
    acc = _const(reduce_identity(op, t), t, ctx)
    for combo in itertools.product(*[range(a.extent)
                                     for a in reversed(axes)]):
        idx = [slice(None)] * val.dim()
        for a, k in zip(reversed(axes), combo):
            idx[ctx.ndim - 1 - a.rpos] = slice(k, k + 1)
        acc = _apply_binop(_COMBINE[op], t, acc, val[tuple(idx)])
    return acc


def _arg_reduce(e: E.Reduce, val: torch.Tensor, axes: List[Axis],
                red) -> torch.Tensor:
    """argmin/argmax: the RDom's points flattened with RDom dim 0 the most
    significant, the first extreme point in that order (the lowest r.x,
    then the lowest r.y, ...; a NaN is extreme, the first NaN wins, as
    jnp.argmax and torch.argmax); value_index k < len(axes) is that
    point's coordinate along dim k, k == len(axes) its value."""
    n, vt = len(axes), e.value.dtype
    big = _uflip(val) if _is_u64(vt) else val
    if big.dtype == torch.bool:
        big = big.to(torch.uint8)
    moved = big.movedim(red, tuple(range(n)))
    flat = moved.reshape((-1,) + tuple(moved.shape[n:]))
    best = (torch.argmax if e.op == "argmax" else torch.argmin)(flat, dim=0)
    k = e.value_index
    if k == n:
        out = flat.gather(0, best.unsqueeze(0)).squeeze(0)
        out = _uflip(out) if _is_u64(vt) else out
        return out.to(val.dtype)
    stride = math.prod(a.extent for a in axes[k + 1:])
    return ((best // stride) % axes[k].extent + axes[k].min).to(torch.int32)


def _factors(e: Expr) -> List[Expr]:
    """The factors of a product (nested muls)."""
    out: List[Expr] = []

    def peel(x):
        if isinstance(x, E.Binary) and x.op == "mul":
            peel(x.a)
            peel(x.b)
        else:
            out.append(x)
    peel(e)
    return out


def _peel_call(e: Expr) -> Optional[E.Call]:
    """The Call under casts that change no value: to f32 from a 16-bit
    float or an integer of at most 16 bits (the conv path reads the Func's
    array and converts it to f32). The JAX package's `_peel_call` looks
    through any cast, so that its conv path skips a narrowing one (a
    bf16 cast of f32 data is not rounded there); the port takes such a
    product elsewhere, with the cast."""
    while isinstance(e, E.Cast):
        src, dst = e.value.dtype, e.dtype
        if not (dst.is_float() and dst.bits == 32 and src.bits <= 16
                and not src.is_bool()):
            return None
        e = e.value
    return e if isinstance(e, E.Call) else None


def try_conv_reduce(e: Expr, ctx: Ctx, red_axes_names):
    """sum over the RDom of W(...) * X(...), X read at strided and shifted
    spatial dims (pure var * s + RVar), one RVar its input feature, W read
    at the output feature and the same RVars -> one torch convolution
    (conv1d/2d/3d, VALID, the strides s), in f32 at full precision, cast
    back to the value's type (the JAX package's `try_conv_reduce` and its
    conv_general_dilated). Returns the reduction shaped like the grid with
    the RDom axes absent or of size 1, or None."""
    factors = _factors(e)
    if len(factors) != 2:
        return None
    if not e.dtype.is_float() or e.dtype.bits > 32:
        return None
    red_set = set(red_axes_names)
    infos = []
    for fct in factors:
        call = _peel_call(fct)
        if call is None:
            return None
        real = ctx.realizations.get(id(call.target))
        if real is None:
            return None
        dims = []
        for a in call.args:
            v = evaluate(a, ctx)
            if not isinstance(v, AVal):
                return None
            dims.append((v, list(v.coeffs)))
        infos.append((call, real, dims))

    def split(vars_):
        return ([n for n in vars_ if n not in red_set],
                [n for n in vars_ if n in red_set])

    def spatialness(info):
        return sum(1 for _v, vars_ in info[2]
                   if tuple(map(len, split(vars_))) == (1, 1))

    infos.sort(key=spatialness)
    w_info, x_info = infos
    if spatialness(x_info) == 0 or spatialness(w_info) != 0:
        return None
    xcall, xreal, xdims = x_info
    wcall, wreal, wdims = w_info

    spatial = []        # (x dim, pure var, stride, rvar, const)
    x_feature = None    # (x dim, rvar, const)
    x_batch = []        # (x dim, pure var)
    x_const = []        # (x dim, const)
    for j, (v, vars_) in enumerate(xdims):
        ps, rs = split(vars_)
        if len(ps) == 1 and len(rs) == 1:
            s = v.coeffs[ps[0]]
            if v.coeffs[rs[0]] != 1 or s < 1:
                return None
            spatial.append((j, ps[0], s, rs[0], v.const))
        elif len(ps) == 1 and not rs:
            if v.coeffs[ps[0]] != 1:
                return None
            x_batch.append((j, ps[0]))
        elif len(rs) == 1 and not ps:
            if v.coeffs[rs[0]] != 1 or x_feature is not None:
                return None
            x_feature = (j, rs[0], v.const)
        elif not ps and not rs:
            x_const.append((j, v.const))
        else:
            return None
    if x_feature is None or not spatial or len(spatial) > 3:
        return None
    spatial_rvars = {s[3] for s in spatial}
    if x_feature[1] in spatial_rvars:
        return None

    w_out = None        # (w dim, pure var)
    w_feature = None    # (w dim, const)
    w_spatial = {}      # rvar -> (w dim, const)
    w_const = []
    for j, (v, vars_) in enumerate(wdims):
        ps, rs = split(vars_)
        if len(ps) == 1 and not rs:
            if w_out is not None or v.coeffs[ps[0]] != 1:
                return None
            w_out = (j, ps[0])
        elif len(rs) == 1 and not ps:
            rv = rs[0]
            if v.coeffs[rv] != 1:
                return None
            if rv == x_feature[1]:
                if w_feature is not None:
                    return None
                w_feature = (j, v.const)
            elif rv in spatial_rvars:
                w_spatial[rv] = (j, v.const)
            else:
                return None
        elif not ps and not rs:
            w_const.append((j, v.const))
        else:
            return None
    if w_out is None or w_feature is None:
        return None
    if set(w_spatial) != spatial_rvars:
        return None
    if red_set - spatial_rvars - {x_feature[1]}:
        return None     # every RDom axis is a feature or a spatial one

    # X: the box each dim reads, in array coordinates
    X = xreal.arrays[xcall.value_index]
    ndx = X.dim()
    box = [(0, n) for n in X.shape]
    for (j, pv, s, rv, c0) in spatial:
        ax, rax = ctx.axes[pv], ctx.axes[rv]
        lo = c0 + s * ax.min + rax.min - xreal.mins[j]
        ln = s * (ax.extent - 1) + rax.extent
        if lo < 0 or lo + ln > X.shape[ndx - 1 - j]:
            return None
        box[ndx - 1 - j] = (lo, ln)
    j, rv, c0 = x_feature
    rax = ctx.axes[rv]
    lo = c0 + rax.min - xreal.mins[j]
    if lo < 0 or lo + rax.extent > X.shape[ndx - 1 - j]:
        return None
    box[ndx - 1 - j] = (lo, rax.extent)
    for (j, pv) in x_batch:
        ax = ctx.axes[pv]
        lo = ax.min - xreal.mins[j]
        if lo < 0:
            return None
        box[ndx - 1 - j] = (lo, ax.extent)
    for (j, c0) in x_const:
        box[ndx - 1 - j] = (c0 - xreal.mins[j], 1)
    lhs = X
    for a, (lo, ln) in enumerate(box):
        lhs = lhs.narrow(a, lo, ln)
    if x_const:
        lhs = lhs.squeeze([ndx - 1 - j for j, _ in x_const])

    def np_pos(j, nd, consts):
        p = nd - 1 - j
        return p - sum(1 for jc, _ in consts if nd - 1 - jc < p)

    # lhs as [batch, spatial..., feature], the batch dims collapsed
    keep = [j for j, _ in x_batch] + [s[0] for s in spatial] + [x_feature[0]]
    lhs = lhs.permute([np_pos(j, ndx, x_const) for j in keep])
    nb = len(x_batch)
    bshape = lhs.shape[:nb]
    lhs = lhs.reshape((-1,) + tuple(lhs.shape[nb:]))

    # W as [spatial..., in feature, out feature]
    Wt = wreal.arrays[wcall.value_index]
    ndw = Wt.dim()
    wbox = [(0, n) for n in Wt.shape]
    for rv, (j, c0) in w_spatial.items():
        rax = ctx.axes[rv]
        lo = c0 + rax.min - wreal.mins[j]
        if lo < 0 or lo + rax.extent > Wt.shape[ndw - 1 - j]:
            return None
        wbox[ndw - 1 - j] = (lo, rax.extent)
    j, c0 = w_feature
    rax = ctx.axes[x_feature[1]]
    lo = c0 + rax.min - wreal.mins[j]
    if lo < 0 or lo + rax.extent > Wt.shape[ndw - 1 - j]:
        return None
    wbox[ndw - 1 - j] = (lo, rax.extent)
    jo, co_var = w_out
    axo = ctx.axes[co_var]
    lo = axo.min - wreal.mins[jo]
    if lo < 0:
        return None
    wbox[ndw - 1 - jo] = (lo, axo.extent)
    for (j, c0) in w_const:
        wbox[ndw - 1 - j] = (c0 - wreal.mins[j], 1)
    rhs = Wt
    for a, (lo, ln) in enumerate(wbox):
        rhs = rhs.narrow(a, lo, ln)
    if w_const:
        rhs = rhs.squeeze([ndw - 1 - j for j, _ in w_const])
    rhs = rhs.permute([np_pos(w_spatial[s[3]][0], ndw, w_const)
                       for s in spatial]
                      + [np_pos(w_feature[0], ndw, w_const),
                         np_pos(jo, ndw, w_const)])

    # torch's layouts: input [N, C, S...], weight [O, I, S...]
    nsp = len(spatial)
    conv = (torch.nn.functional.conv1d, torch.nn.functional.conv2d,
            torch.nn.functional.conv3d)[nsp - 1]
    with contract_precision():
        out = conv(lhs.movedim(-1, 1).float(),
                   rhs.permute([nsp + 1, nsp] + list(range(nsp))).float(),
                   stride=tuple(s[2] for s in spatial))
    out = out.movedim(1, -1)                      # [N, S..., O]
    out = out.reshape(tuple(bshape) + tuple(out.shape[1:]))
    out_axes_order = [pv for _, pv in x_batch] + [s[1] for s in spatial] \
        + [co_var]
    perm_dst = [ctx.ndim - 1 - ctx.axes[nm].rpos for nm in out_axes_order]
    out = out.permute([i for _, i in sorted(zip(perm_dst,
                                                range(len(perm_dst))))])
    shape = [1] * ctx.ndim
    for nm in out_axes_order:
        shape[ctx.ndim - 1 - ctx.axes[nm].rpos] = ctx.axes[nm].extent
    return out.reshape(shape).to(compute_dtype(e.dtype))


def try_einsum_reduce(e: Expr, ctx: Ctx, red_np_axes):
    """sum over the RDom of a product of factors -> one contraction,
    never the outer-product grid (the JAX package's `try_einsum_reduce`),
    where the grid has at least `_EINSUM_MIN_FULL` elements. Floats:
    torch.einsum in f32 (16-bit floats upcast first: their products are
    exact there, as the JAX package's f32-accumulating contraction) or f64,
    at full precision, cast to the value's type. Integers: a chunked
    multiply and sum in int64 (`_int_contract`), which wraps to the Type as
    the JAX package's int32/int64 accumulation does. Returns the
    reduction shaped like the grid with size-1 RDom axes, or None."""
    factors = _factors(e)
    if len(factors) < 2:
        return None
    full = full_shape(ctx, list(ctx.axes.values()))
    if math.prod(full) < _EINSUM_MIN_FULL:
        return None
    ops, positions = [], []
    for fct in factors:
        arr = eval_array(fct, ctx)
        pad = ctx.ndim - arr.dim()
        pos = [pad + a for a in range(arr.dim()) if arr.shape[a] != 1]
        ops.append(arr.reshape([arr.shape[a] for a in range(arr.dim())
                                if arr.shape[a] != 1]))
        positions.append(pos)
    outpos = sorted({p for ps in positions for p in ps} - set(red_np_axes))
    shape = [1] * ctx.ndim
    if not e.dtype.is_float():
        r = _int_contract(ops, positions, red_np_axes, ctx.ndim)
        return cast_value(r, Int(64), e.dtype)
    acc = torch.float32 if e.dtype.bits <= 32 else torch.float64
    spec = ",".join("".join(_LETTERS[p] for p in pos)
                    for pos in positions) \
        + "->" + "".join(_LETTERS[p] for p in outpos)
    with contract_precision():
        r = torch.einsum(spec, *[a.to(acc) for a in ops])
    for p, s in zip(outpos, r.shape):
        shape[p] = s
    return r.reshape(shape).to(compute_dtype(e.dtype))


def _int_contract(ops, positions, red, nd: int) -> torch.Tensor:
    """sum over the axes `red` of the product of integer factors (each
    over the axes `positions`), in int64: the card's matrix products take
    no integers. Chunked along the largest reduced axis, so that no chunk's
    product grid passes `_INT_CHUNK` elements. Shaped like the grid (nd
    axes), the reduced ones of size 1."""
    full = [1] * nd
    shaped = []
    for arr, pos in zip(ops, positions):
        shp = [1] * nd
        for p, s in zip(pos, arr.shape):
            shp[p] = full[p] = s
        shaped.append(arr.to(torch.int64).reshape(shp))
    red = sorted(red)
    k = max(red, key=lambda a: full[a])
    step = max(1, _INT_CHUNK // max(1, math.prod(full) // full[k]))
    acc = None
    for lo in range(0, full[k], step):
        n = min(step, full[k] - lo)
        part = None
        for a in shaped:
            a = a.narrow(k, lo, n) if a.shape[k] != 1 else a
            part = a if part is None else part * a
        part = part.sum(dim=red, keepdim=True)
        acc = part if acc is None else acc + part
    return acc

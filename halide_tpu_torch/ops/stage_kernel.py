"""The stage kernel: an untiled whole-array stage computed by one emitted
CUDA kernel, in place of one PyTorch kernel per expression node.

A materialized Func that the stencil-group kernel (K1) does not take, with
one pure definition and one value, is computed on the card by a kernel
emitted from its definition; every other stage, and every stage on the
CPU, is evaluated whole-array by eval_torch as before (`compute` returns
None and counts the reason).

- Bound: device-memory bytes. Each input read once and the output written
  once at 3.35 TB/s on an H100 SXM: the stage's intermediates live in
  registers, where eval_torch writes each node's result to device memory
  at the stage's full size.
- Design: one thread computes V consecutive outputs along the innermost
  stored dim (Func dim 0), V chosen so that its stores are 16 bytes where
  the extent allows (else 8, 4, ... bytes, else 1 output); the flattened
  outer dims are walked by a grid-stride loop, 256 threads a block, at most
  `_MAX_BLOCKS` blocks (the 132 SMs filled several times). Indices are
  32-bit where every array the stage touches has fewer than 2^31 elements,
  else 64-bit. There are no shared-memory windows: a stencil's reuse comes
  from L1 and L2, so a stage of any rank and size runs (resnet_50's 4-D
  stages with c up to 2048), where K1 stages whole windows.
- The expression is emitted by K1's `_PointEmitter` (the same arithmetic,
  casts, inline Reduce loops, Let, lerp and intrinsics, built with the
  same `-fmad=false`), with inline Funcs substituted and equal
  subexpressions merged (`_Expander`), so that a value an inline Func
  computes once (softmax's maximum) is computed once per output. A read of
  a realized input is a load from its device array at its affine, div-
  indexed or data-dependent index; where the bounds do not prove an index
  inside the array's realized region it is clamped into that region, as
  eval_torch's edge replication and gathers clip it, and a clamp of an
  index the bounds prove inside its own limits is dropped.
- An inline sum that eval_torch would lower to a library contraction
  (cuDNN's convolution or an einsum) is left to it: eval_torch's own
  checks decide, run on meta tensors (`eval_torch.contraction_probe`).

Extents, mins and strides are launch arguments, and the source holds no
name: the same expression at another size or pyramid level has the same
source, whose key (`stage_<key>` kernels) is its content. The stages of a
plan are emitted on its first run (`prepare`) and built together, one
translation unit by one nvcc call, into `build/kernels/stages_<hash>.so`
(ops/build.load, the port's one build route), loaded from there after
that; a stage planned later (one that K1 declined) builds on its own. A
kernel takes its launch's arguments as one by-value array of int64
(`launch_args`), which its launcher `launch_stage_<key>` copies in. The
source also compiles with a host C++ compiler, where `host_stage_<key>`
computes every output on one thread (the CPU tests hold it against
eval_torch).

A launch goes on PyTorch's current stream and does not wait: a plan's CUDA
graph captures it. A build, load or launch failure raises; it never falls
back. Counters: `fused` (stages computed by the kernel), `declined`
(stages on the card left to eval_torch), `rejects` (every decline by
reason, those on the CPU too).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import math
from typing import Dict, List, Optional, Tuple

import torch

from .. import expr as E
from ..bounds import BoundsEngine, Interval
from ..eval_torch import Axis, Ctx, Realized
from ..expr import CompileError
from ..func import Func
from ..htypes import Type, torch_dtype
from ..visitors import mutate, substitute
from ..visitors import walk as walk_expr
from . import build as _build
from .group_kernel import (GroupUnsupported, _cname, _ctx_resolver,
                           _match_clamp, _PointEmitter, ctype, itemsize)

fused = 0
declined = 0
rejects: collections.Counter = collections.Counter()

THREADS = 256
# a launch's blocks at most: 32 a SM of an H100 SXM's 132, four times
# the 256-thread blocks it keeps resident
_MAX_BLOCKS = 132 * 32
# unique expression nodes a stage may hold once its inline Funcs are
# substituted; a larger one stays with eval_torch
_MAX_NODES = 1 << 14

# where set (`declining`), every stage declines with this reason
_DECLINE: List[Optional[str]] = [None]
# where set (`collecting`), a plan's first run plans its stage kernels into
# this list and builds none
_COLLECT: List[Optional[list]] = [None]
# key -> that stage kernel's launcher, loaded
_launchers: Dict[str, object] = {}


class StageDeclined(Exception):
    """The stage kernel does not take this stage: eval_torch evaluates
    it."""


@contextlib.contextmanager
def declining(reason: str):
    """While it holds, every stage is left to eval_torch for `reason` (the
    shards of a distributed realize)."""
    old = _DECLINE[0]
    _DECLINE[0] = reason
    try:
        yield
    finally:
        _DECLINE[0] = old


@contextlib.contextmanager
def collecting():
    """While it holds, a plan's first run plans its stages' kernels and
    builds none (its stages stay with eval_torch): -> the list the specs
    go to, for `build` to build later (the chip check builds every source
    at once, in parallel)."""
    old = _COLLECT[0]
    _COLLECT[0] = specs = []
    try:
        yield specs
    finally:
        _COLLECT[0] = old


class StageSpec:
    """One stage's kernel as planned for its regions: `source` (named by
    `key`), the reads in launch order (`slots`: (id of the target, value
    index)), each read array's realized mins and shape and Type as the
    plan assumed them (`regions`), the output's Type, box and V, whether
    indices are 64-bit, and the least bytes it moves (`bytes`: what it
    reads of each input once, its output once)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


# ---------------------------------------------------------------------------
# what the kernel takes
# ---------------------------------------------------------------------------

def why_not(f: Func) -> Optional[str]:
    """Why the stage kernel does not take f, from its definition and
    schedule; None where nothing there stops it."""
    if f.is_extern():
        return "an extern stage"
    if len(f._defs) > 1:
        return "update definitions"
    if len(f._defs[0].values) > 1:
        return "several values"
    fs = f._fschedule
    if fs.memoized:
        return "memoized"
    if fs.trace_loads or fs.trace_stores or fs.trace_realizations:
        return "traced"
    if fs.debug_file:
        return "debug_to_file"
    if any(d.schedule.fused_with for d in f._defs):
        return "a compute_with clique member"
    v = f._defs[0].values[0]
    if isinstance(v, E.Intrin) and v.name == "undef":
        return "undef"
    return None


def _unplanned(ctx0: Ctx) -> Optional[str]:
    """Why no stage of this realize is planned: a shard, or a traced Param
    (the kernel compiles each Param's value in)."""
    if _DECLINE[0] is not None:
        return _DECLINE[0]
    if any(isinstance(p, torch.Tensor) for p in ctx0.params.values()):
        return "a traced Param"
    return None


def why_not_now(ctx0: Ctx) -> Optional[str]:
    """Why no stage of this realize goes to the stage kernel, from the
    realize itself (these reasons are not kept with a plan); None where
    nothing stops it."""
    reason = _unplanned(ctx0)
    if reason is not None:
        return reason
    if _COLLECT[0] is not None:
        return "the stages are planned, not built"
    from .group_kernel import _PLANNING
    if _PLANNING[0] is not None:
        return "the groups are planned, not computed"
    from .export_ops import exporting
    if exporting():
        return "a program is being exported"
    return None


# ---------------------------------------------------------------------------
# the expression: inline Funcs substituted, equal subexpressions merged
# ---------------------------------------------------------------------------

def _leaf_key(a):
    """A non-Expr argument of an intrinsic (a Param, a tag) in a key."""
    if isinstance(a, (int, float, str, bool)) or a is None:
        return (type(a).__name__, a)
    return ("id", id(a))


class _Expander:
    """Substitutes every read of an inline Func (a Func with no region:
    its pure definition's value, as eval_torch evaluates it) and merges
    equal nodes, so that the expression is a DAG whose shared nodes the
    emitter computes once."""

    def __init__(self, regions: dict):
        self.regions = regions
        self.table: dict = {}
        self.inlined: dict = {}

    def key(self, n):
        t = (n.dtype.code, n.dtype.bits) if n.dtype is not None else None
        if isinstance(n, E.IntImm):
            return ("i", t, n.value)
        if isinstance(n, E.FloatImm):
            return ("f", t, float(n.value).hex())
        if isinstance(n, E.StringImm):
            return ("s", n.value)
        if isinstance(n, E.Variable):
            return ("v", t, n.name)
        if isinstance(n, (E.Cast, E.Reinterpret)):
            return (type(n).__name__, t, id(n.value))
        if isinstance(n, E.Binary):
            return ("b", n.op, t, id(n.a), id(n.b))
        if isinstance(n, E.Not):
            return ("n", id(n.a))
        if isinstance(n, E.Select):
            return ("?", id(n.cond), id(n.true_value), id(n.false_value))
        if isinstance(n, E.Call):
            return ("c", id(n.target), n.value_index, t,
                    tuple(id(a) for a in n.args))
        if isinstance(n, E.Intrin):
            return ("in", n.name, t, tuple(
                id(a) if isinstance(a, E.Expr) else _leaf_key(a)
                for a in n.args))
        if isinstance(n, E.Let):
            return ("l", n.name, id(n.value), id(n.body))
        if isinstance(n, E.Reduce):
            return ("r", n.op, t, id(n.value), id(n.rdom),
                    id(n.where) if n.where is not None else None,
                    n.value_index)
        return ("x", id(n))

    def canon(self, n):
        k = self.key(n)
        hit = self.table.get(k)
        if hit is not None:
            return hit
        if len(self.table) >= _MAX_NODES:
            raise StageDeclined(f"more than {_MAX_NODES} expression nodes")
        self.table[k] = n
        return n

    def expand(self, e):
        def fn(n):
            if isinstance(n, E.Call) and isinstance(n.target, Func) and \
                    id(n.target) not in self.regions:
                return self.inline(n)
            return self.canon(n)
        return mutate(e, fn)

    def inline(self, call: E.Call):
        k = (id(call.target), call.value_index,
             tuple(id(a) for a in call.args))
        hit = self.inlined.get(k)
        if hit is None:
            t = call.target
            if not t.defined():
                raise StageDeclined(f"Func {t.name} is undefined")
            binds = {v.name: a for v, a in zip(t.args(), call.args)}
            hit = self.inlined[k] = self.expand(
                substitute(t._defs[0].values[call.value_index], binds))
        return hit


# ---------------------------------------------------------------------------
# reads: which indices the bounds prove inside, which clamps they drop
# ---------------------------------------------------------------------------

def _reads(value, scope, regions: dict, engine: BoundsEngine):
    """-> ({(id(call), dim): True where the index is clamped into the
    region}, {(id(call), dim): the index with a clamp dropped}, {(id of
    target, value index): [Interval per dim] of its reads}) over every
    scope a read is met in."""
    clamp: dict = {}
    strip: dict = {}
    touched: dict = {}
    seen = set()
    scopes = [scope]                  # kept alive: their ids key `seen`

    def inside(iv, lo, hi):
        return iv.is_bounded() and iv.lo >= lo and iv.hi <= hi

    def visit(e, sc):
        if (id(e), id(sc)) in seen:
            return
        seen.add((id(e), id(sc)))
        if isinstance(e, E.Call):
            for a in e.args:
                visit(a, sc)
            mins, arrs = regions[id(e.target)]
            shape = arrs[e.value_index][0]
            nd = len(shape)
            ivs = touched.setdefault((id(e.target), e.value_index), [])
            for j, a in enumerate(e.args):
                m = _match_clamp(a)
                if m is not None:
                    inner, lo_e, hi_e = m
                    lo, hi = engine.bounds(lo_e, sc), engine.bounds(hi_e, sc)
                    ok = lo.is_bounded() and hi.is_bounded() and \
                        lo.lo == lo.hi and hi.lo == hi.hi and \
                        inside(engine.bounds(inner, sc), lo.lo, hi.hi)
                    if strip.get((id(e), j), inner) is not False:
                        strip[(id(e), j)] = inner if ok else False
                    if ok:
                        a = inner
                iv = engine.bounds(a, sc)
                rlo, rhi = mins[j], mins[j] + shape[nd - 1 - j] - 1
                if not inside(iv, rlo, rhi):
                    clamp[(id(e), j)] = True
                    iv = iv.intersect(Interval(rlo, rhi)) \
                        if iv.is_bounded() else Interval(rlo, rhi)
                if len(ivs) <= j:
                    ivs.append(iv)
                else:
                    ivs[j] = ivs[j].union(iv)
            return
        if isinstance(e, E.Let):
            visit(e.value, sc)
            child = dict(sc)
            child[e.name] = engine.bounds(e.value, sc)
            scopes.append(child)
            visit(e.body, child)
            return
        if isinstance(e, E.Reduce):
            child = engine.rdom_scope(e.rdom, sc)
            scopes.append(child)
            for c in [e.value, e.where] + list(e.rdom.predicates):
                if c is not None:
                    visit(c, child)
            return
        for c in e.children():
            visit(c, sc)

    visit(value, scope)
    return clamp, {k: v for k, v in strip.items() if v is not False}, touched


class _StageEmitter(_PointEmitter):
    """K1's point emitter with reads from device arrays: input k of the
    launch is `p.in<k>`, its strides, realized mins and sizes `p.st<k>`,
    `p.mn<k>`, `p.sz<k>` (per pipeline dim)."""

    def __init__(self, ctx0: Ctx, scope: Dict[str, str], regions: dict,
                 clamp: dict, strip: dict, index_type: str):
        super().__init__({}, ctx0, scope)
        self.regions = regions
        self.clamp = clamp
        self.strip = strip
        self.index_type = index_type
        self.slots: List[Tuple[int, int]] = []
        self.slot_of: Dict[Tuple[int, int], int] = {}

    def _read(self, e: E.Call) -> str:
        tid = id(e.target)
        if tid not in self.regions:
            raise StageDeclined(
                f"read of {getattr(e.target, 'name', '?')}, not realized")
        sk = (tid, e.value_index)
        k = self.slot_of.get(sk)
        if k is None:
            k = self.slot_of[sk] = len(self.slots)
            self.slots.append(sk)
        t = self.regions[tid][1][e.value_index][1]
        parts = []
        for j, a in enumerate(e.args):
            av = f"(int){self.val(self.strip.get((id(e), j), a))}"
            if self.clamp.get((id(e), j)):
                av = (f"hl_min<int>(hl_max<int>({av}, p.mn{k}[{j}]), "
                      f"p.mn{k}[{j}] + p.sz{k}[{j}] - 1)")
            parts.append(f"({self.index_type})({av} - p.mn{k}[{j}]) * "
                         f"p.st{k}[{j}]")
        return self.let(t, f"p.in{k}[{' + '.join(parts) or '0'}]")


# ---------------------------------------------------------------------------
# planning and emission
# ---------------------------------------------------------------------------

def regions_of(realizations: Dict[int, Realized], stages=()) -> dict:
    """id(target) -> (mins, [(shape, Type or None)] per value) of the
    realized arrays (the Type filled in where a stage reads it), and of the
    arrays a plan will realize: each (Func, box) of `stages` over its
    box."""
    out = {tid: (tuple(r.mins), [(tuple(a.shape), None) for a in r.arrays])
           for tid, r in realizations.items()}
    for f, box in stages:
        types = [f._extern["type"]] if f.is_extern() else f.output_types()
        out[id(f)] = (tuple(box.mins()), [
            (tuple(reversed(box.extents())), t) for t in types])
    return out


def _typed(regions: dict, value) -> dict:
    """`regions` with the Type of every read value filled in (a Call's
    dtype: the target's value type)."""
    out = dict(regions)

    def fn(n):
        if isinstance(n, E.Call) and id(n.target) in out:
            mins, arrs = out[id(n.target)]
            shape, t = arrs[n.value_index]
            if t is None:
                arrs = list(arrs)
                arrs[n.value_index] = (shape, n.dtype)
                out[id(n.target)] = (mins, arrs)
    walk_expr(value, fn)
    return out


def _vector(t: Type, ext0: int) -> int:
    """Outputs a thread stores at once: 16 bytes of them where the
    innermost extent is a multiple of that count, else fewer."""
    v = max(1, 16 // itemsize(t))
    while v > 1 and ext0 % v:
        v //= 2
    return v


def plan_stage(f: Func, box, ctx0: Ctx, regions: dict) -> StageSpec:
    """The kernel of f over `box`, reading the arrays `regions` describes
    (`regions_of`: the realized arrays, or those a plan will realize).
    Raises StageDeclined where the kernel does not take f."""
    reason = why_not(f) or _unplanned(ctx0)
    if reason is not None:
        raise StageDeclined(reason)
    dims = [v.name for v in f._defs[0].args]
    mins, exts = [int(m) for m in box.mins()], [int(e) for e in box.extents()]
    ex = _Expander(regions)
    value = ex.expand(f._defs[0].values[0])
    regions = _typed(regions, value)
    engine = BoundsEngine(resolver=_ctx_resolver(ctx0))
    scope = {d: Interval(m, m + e - 1) for d, m, e in zip(dims, mins, exts)}
    try:
        clamp, strip, touched = _reads(value, scope, regions, engine)
    except (KeyError, CompileError) as ex2:
        raise StageDeclined(f"bounds of a read: {ex2}") from ex2
    out_type = f._defs[0].values[0].dtype
    numel = math.prod(exts)
    # a 32-bit thread step stays below 2^31 after its last stride too
    wide = numel + _MAX_BLOCKS * THREADS >= 1 << 31 or any(
        math.prod(shape) >= 1 << 31
        for _m, arrs in regions.values() for shape, _t in arrs)
    index_type = "long long" if wide else "int"
    em = _StageEmitter(ctx0, {d: _cname(d) for d in dims}, regions, clamp,
                       strip, index_type)
    try:
        ctype(out_type)
        result = em.val(value)
    except (GroupUnsupported, CompileError) as ex2:
        raise StageDeclined(str(ex2)) from ex2
    _probe(f, box, ctx0, regions, value)
    vec = _vector(out_type, exts[0]) if dims else 1
    slots = [(tid, vi, regions[tid][0], regions[tid][1][vi][0],
              regions[tid][1][vi][1]) for tid, vi in em.slots]
    source = _emit(em, dims, result, out_type, vec, index_type,
                   [(t, len(shape)) for _tid, _vi, _m, shape, t in slots])
    key = hashlib.sha1(source.encode()).hexdigest()[:16]
    nbytes = numel * itemsize(out_type) + sum(
        math.prod(max(0, int(iv.extent())) for iv in touched[(tid, vi)])
        * itemsize(t) for tid, vi, _m, _s, t in slots)
    return StageSpec(
        f=f, name=f.name, key=key, symbol=f"stage_{key}",
        source=source.replace("@K@", key),
        slots=[(tid, vi) for tid, vi, _m, _s, _t in slots],
        regions=[(m, s, t) for _tid, _vi, m, s, t in slots],
        out_type=out_type, mins=mins, extents=exts, vec=vec, wide=wide,
        bytes=nbytes)


def _probe(f: Func, box, ctx0: Ctx, regions: dict, value) -> None:
    """Decline where eval_torch would lower an inline sum of the stage to a
    library contraction: its own evaluation, on meta tensors of the
    regions' shapes, under `eval_torch.contraction_probe`, where the
    expanded `value` holds a sum of a product. An operation meta tensors
    cannot run (one whose result's shape depends on the data, or a read of
    a value) declines too; any other error of the evaluation raises."""
    from .. import eval_torch as et
    # the library paths take a sum of a product of two factors or more,
    # and substituting inline Funcs only adds factors: a stage without
    # one needs no probe (whose meta tensors cost seconds of imports)
    sums = []
    walk_expr(value, lambda n: sums.append(n) if isinstance(n, E.Reduce)
              and n.op == "sum" and len(et._factors(n.value)) > 1 else None)
    if not sums:
        return
    realz = {tid: Realized(tuple(torch.empty(shape, dtype=torch_dtype(t)
                                             if t is not None
                                             else torch.float32,
                                             device="meta")
                                 for shape, t in arrs), mins)
             for tid, (mins, arrs) in regions.items()}
    axes = {v.name: Axis(v.name, i, int(box.dims[i].lo),
                         int(box.dims[i].extent()))
            for i, v in enumerate(f._args)}
    ctx = Ctx(f.dimensions(), axes, {}, realz, ctx0.params, "meta")
    with et.contraction_probe():
        try:
            et.eval_array(f._defs[0].values[0], ctx)
        except et.Contraction as ex:
            raise StageDeclined(f"an inline sum on the {ex} path") from ex
        except NotImplementedError as ex:
            raise StageDeclined("the contraction probe: an operation with "
                                "no meta version") from ex
        except RuntimeError as ex:
            if "meta tensors" not in str(ex):
                raise
            raise StageDeclined("the contraction probe: a value read from "
                                "a meta tensor") from ex


def _emit(em: _StageEmitter, dims: List[str], result: str, out_type: Type,
          vec: int, index_type: str, reads) -> str:
    """The kernel's source, `@K@` in place of its key: the parameters, the
    point function, the walk of one thread's outputs, the unpacking of the
    launch's int64 arguments (`launch_args`), and the kernel (nvcc: one
    by-value parameter, those arguments) or its host loop (a host
    compiler)."""
    it, ct, nd = index_type, ctype(out_type), len(dims)
    L = ["", f"// stage @K@: {nd}-D output, {len(reads)} reads, "
         f"{vec} outputs a thread", "struct P_@K@ {"]
    for k, (t, n) in enumerate(reads):
        L.append(f"  const {ctype(t)}* in{k};")
        if n:
            L.append(f"  {it} st{k}[{n}]; int mn{k}[{n}]; int sz{k}[{n}];")
    L.append(f"  {ct}* out;")
    if nd:
        L.append(f"  int omn[{nd}]; int oext[{nd}];")
    L += [f"  {it} total;", "};", ""]
    params = "".join(f", int {_cname(d)}" for d in dims)
    L.append(f"HL_FN {ct} point_@K@(const P_@K@& p{params}) {{")
    L += ["  (void)p;"] + em.lines
    L += [f"  return hl_cast<{ct}>({result});", "}", ""]
    L.append(f"HL_FN void body_@K@(const P_@K@& p, {it} i) {{")
    if nd == 0:
        L.append("  (void)i;")
        L.append("  p.out[0] = point_@K@(p);")
    else:
        rem = "i"
        coords = []
        for d in range(nd):
            if d == nd - 1:
                c = f"(int){rem}" + (f" * {vec}" if d == 0 else "")
            else:
                ext = f"(p.oext[0] / {vec})" if d == 0 else f"p.oext[{d}]"
                c = f"(int)({rem} % {ext})" + (f" * {vec}" if d == 0 else "")
                L.append(f"  const {it} q{d} = {rem} / {ext};")
                rem = f"q{d}"
            L.append(f"  const int c{d} = {c};")
            coords.append(f"p.omn[{d}] + c{d}")
        L += [f"  {ct} v[{vec}];", "#pragma unroll",
              f"  for (int u = 0; u < {vec}; ++u)",
              f"    v[u] = point_@K@(p, {coords[0]} + u"
              + "".join(f", {c}" for c in coords[1:]) + ");",
              f"  hl_store<{ct}, {vec}>(p.out + i * {vec}, v);"]
    L += ["}", ""]
    # the launcher's arguments, in `launch_args`'s order
    fields = []
    for k, (t, n) in enumerate(reads):
        fields.append((f"p.in{k}", f"const {ctype(t)}*"))
        for j in range(n):
            fields += [(f"p.st{k}[{j}]", it), (f"p.mn{k}[{j}]", "int"),
                       (f"p.sz{k}[{j}]", "int")]
    fields.append(("p.out", f"{ct}*"))
    for j in range(nd):
        fields += [(f"p.omn[{j}]", "int"), (f"p.oext[{j}]", "int")]
    fields.append(("p.total", it))
    L.append(f"HL_FN void fill_@K@(P_@K@& p, const long long* a) {{")
    L += [f"  {lhs} = ({cast})a[{i}];"
          for i, (lhs, cast) in enumerate(fields)]
    L += ["}", ""]
    L += [
        "#ifdef __CUDACC__",
        f"struct A_@K@ {{ long long a[{len(fields)}]; }};",
        "",
        f'extern "C" __global__ void __launch_bounds__({THREADS}) '
        "stage_@K@(const A_@K@ args) {",
        "  P_@K@ p;",
        "  fill_@K@(p, args.a);",
        f"  for ({it} i = ({it})blockIdx.x * blockDim.x + threadIdx.x; "
        f"i < p.total; i += ({it})gridDim.x * blockDim.x)",
        "    body_@K@(p, i);",
        "}",
        "",
        'extern "C" int launch_stage_@K@(const long long* a, int blocks, '
        "void* stream) {",
        "  A_@K@ args;",
        "  memcpy(args.a, a, sizeof(args.a));",
        f"  stage_@K@<<<blocks, {THREADS}, 0, (cudaStream_t)stream>>>(args);",
        "  return (int)cudaGetLastError();",
        "}",
        "#else",
        'extern "C" int host_stage_@K@(const long long* a) {',
        "  P_@K@ p;",
        "  fill_@K@(p, a);",
        f"  for ({it} i = 0; i < p.total; ++i) body_@K@(p, i);",
        "  return 0;",
        "}",
        "#endif",
    ]
    return "\n".join(L) + "\n"


def translation_unit(specs: List[StageSpec]) -> str:
    """One source of the kernels of `specs` (each key once, in key
    order)."""
    by_key = {s.key: s for s in specs}
    return "\n".join(
        ["// Whole-array stage kernels, emitted by halide_tpu_torch/ops/"
         "stage_kernel.py", '#include "stage_kernel.cuh"']
        + [by_key[k].source for k in sorted(by_key)])


# ---------------------------------------------------------------------------
# build and launch
# ---------------------------------------------------------------------------

def build(specs: List[StageSpec]) -> None:
    """Build the kernels of `specs` not yet loaded, all in one translation
    unit by one nvcc call (ops/build.load: once per content, loaded from
    build/kernels after that), and bind each kernel's launcher. Raises
    with nvcc's stderr on a failure."""
    todo = [s for s in specs if s.key not in _launchers]
    if not todo:
        return
    text = translation_unit(todo)
    # the key holds the fixed headers too: an edited helper builds anew
    key = _build.source_key("stages", text + "".join(
        (_build.CSRC / h).read_text()
        for h in ("stage_kernel.cuh", "group_kernel.cuh")))
    cu = _build.BUILD_DIR / f"{key}.cu"
    if not (_build.BUILD_DIR / f"{key}.so").exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu.write_text(text)
    lib = _build.load(key, cu)
    for s in todo:
        fn = getattr(lib, f"launch_{s.symbol}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launchers[s.key] = fn


def launch_args(spec: StageSpec, arrays, out: torch.Tensor) -> list:
    """The launcher's int64 arguments: each read array's pointer, then its
    stride, realized min and size per pipeline dim; the output's pointer,
    min and extent per dim; the count of thread steps."""
    vals = []
    for a, (mins, _shape, _t) in zip(arrays, spec.regions):
        nd = a.ndim
        vals.append(a.data_ptr())
        for j in range(nd):
            vals += [a.stride(nd - 1 - j), mins[j], a.shape[nd - 1 - j]]
    vals.append(out.data_ptr())
    for m, e in zip(spec.mins, spec.extents):
        vals += [m, e]
    vals.append(math.prod(spec.extents) // spec.vec)
    return vals


def _arrays(spec: StageSpec, ctx0: Ctx):
    """The arrays the kernel reads, or None where the realize's arrays are
    not those the spec was planned for (another region, dtype or index
    width)."""
    arrays = []
    for (tid, vi), (mins, shape, t) in zip(spec.slots, spec.regions):
        real = ctx0.realizations.get(tid)
        if real is None or tuple(real.mins) != tuple(mins):
            return None
        a = real.arrays[vi]
        if tuple(a.shape) != tuple(shape) or a.dtype != torch_dtype(t) \
                or a.device.type != "cuda":
            return None
        if not spec.wide and sum((n - 1) * s for n, s in zip(
                a.shape, a.stride())) >= 1 << 31:
            return None
        arrays.append(a)
    return arrays


def launch(spec: StageSpec, arrays, dev: torch.device) -> torch.Tensor:
    """Launch the stage's kernel on the current stream; the output is
    allocated here, contiguous, in the stage's storage dtype. Raises on a
    launch error."""
    out = torch.empty(tuple(reversed(spec.extents)),
                      dtype=torch_dtype(spec.out_type), device=dev)
    vals = launch_args(spec, arrays, out)
    if vals[-1] > 0:
        rc = _launchers[spec.key](
            (ctypes.c_longlong * len(vals))(*vals),
            min(-(-vals[-1] // THREADS), _MAX_BLOCKS),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"stage kernel launch_{spec.symbol} failed: "
                               f"cudaError {rc}")
    return out


def _decline(reason: str, on_card: bool) -> None:
    global declined
    rejects[reason] += 1
    declined += on_card


def compute(f: Func, box, ctx0: Ctx) -> Optional[Realized]:
    """f over `box` by its stage kernel, or None where the kernel does not
    take it (eval_torch then evaluates it; the reason is counted). The
    plan's kernels (`ctx0.stages`, by Func) are reused; a stage the plan
    did not prepare is planned and built here."""
    global fused
    dev = ctx0.device
    if dev.type != "cuda":
        _decline("a CPU tensor", False)
        return None
    if dev.index is not None and dev.index != torch.cuda.current_device():
        _decline("not the current device", True)
        return None
    reason = why_not_now(ctx0)
    cache = ctx0.stages
    spec = cache.get(id(f)) if cache is not None else None
    if isinstance(spec, str) or reason is not None:
        _decline(reason or spec, True)
        return None
    arrays = _arrays(spec, ctx0) if spec is not None and spec.f is f \
        else None
    try:
        if arrays is None:
            spec = plan_stage(f, box, ctx0, regions_of(ctx0.realizations))
            arrays = _arrays(spec, ctx0)
            if arrays is None:
                raise StageDeclined("an input's dtype or device")
            if cache is not None:
                cache[id(f)] = spec
        if torch.is_grad_enabled() and any(a.requires_grad for a in arrays):
            raise StageDeclined("an input requires a gradient")
    except StageDeclined as ex:
        _decline(str(ex), True)
        return None
    build([spec])                 # nothing where it is loaded
    out = launch(spec, arrays, dev)
    fused += 1
    return Realized((out,), box.mins(), f.name)


def prepare(ctx0: Ctx, regions: dict, todo) -> None:
    """On a plan's first run on the card: plan the kernels of the stages
    `todo` ([(Func, box, the reason it is left to eval_torch or None)]),
    reading the arrays `regions` describes (those realized, and those the
    plan will realize), and build them in one translation unit. Each
    Func's spec, or its reason, goes into `ctx0.stages`."""
    if _COLLECT[0] is not None:
        _COLLECT[0].extend(_plan_all(ctx0, regions, todo))
        return
    if why_not_now(ctx0) is not None:
        return                    # each stage declines as it is met
    build(_plan_all(ctx0, regions, todo))


def _plan_all(ctx0: Ctx, regions: dict, todo) -> List[StageSpec]:
    """Plan each stage of `todo` into `ctx0.stages` (its spec, or the
    reason it is declined); -> the specs."""
    specs = []
    for f, box, reason in todo:
        try:
            if reason is not None:
                raise StageDeclined(reason)
            spec = plan_stage(f, box, ctx0, regions)
        except StageDeclined as ex:
            ctx0.stages[id(f)] = str(ex)
            continue
        ctx0.stages[id(f)] = spec
        specs.append(spec)
    return specs


def stage_calls(pipeline, device=None) -> list:
    """Every whole-array stage of `pipeline`'s last realize (each Func it
    evaluated alone: not a stencil group's consumer or member), in the
    order it ran them, made again so that the kernel can be held against
    eval_torch (the tests, the chip check, the tools; `pipeline.
    last_realize`): each stage planned over its box in the realize's
    planned graph (on the card, the kernels built together),
    then every stored stage evaluated in order (`pipeline._evaluate_func`:
    the stage kernel where it takes the stage). -> [(Func, box, the
    realizations before it, its StageSpec or the reason it is declined,
    its output)]."""
    from ..pipeline import _evaluate_func, last_realize
    dev, planned, _g, realz, params, stored = last_realize(pipeline, device)
    ctx0 = Ctx(0, {}, {}, realz, params, dev, stages={})
    grouped = set()
    for p in planned["groups"].values():
        if p:
            grouped |= {id(p.f)} | {id(m.target) for m in p.members}
    specs = _plan_all(ctx0, regions_of(realz, stored),
                      [(fn, box, None) for fn, box in stored])
    if dev.type == "cuda":
        build(specs)
    out = []
    for fn, box in stored:
        before = dict(realz)
        realz[id(fn)] = _evaluate_func(fn, box, ctx0)
        if id(fn) not in grouped:
            out.append((fn, box, before, ctx0.stages[id(fn)],
                        realz[id(fn)].arrays[0]))
    return out

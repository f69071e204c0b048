"""The stencil-group kernel (K1): a tiled Func and its `compute_at`
producers, computed in one CUDA launch.

It replaces `halide_tpu/ops/pallas_group.py:_lower_group_single` (the
Pallas kernel of the JAX package) for Hopper (sm_90a).

- Bound: device-memory bytes where the work is a few operations per
  element (blur, linear_blur, interpolate, local_laplacian): each input
  read once and the output written once, at 3.35 TB/s on an H100 SXM; the
  producers live in shared memory and never touch device memory. The deep
  groups (stencil_chain's 8 stencils, camera_pipe's demosaic) are bound by
  their operations: f32 adds and multiplies issued alone (`-fmad=false`)
  at 33.5 T/s, 32-bit integer operations at 16.75 T/s.
- Design: a CUDA block computes one sub-tile of the output. The grid walks
  the sub-tiles of the whole output extent, `cdiv(extent, sx)` columns by
  `cdiv(extent_y, sy)` rows, and only the last column and the last row are
  shifted inwards (min(o, extent - sub-tile)): no output is computed by two
  blocks. The schedule's tile decides that the group exists and bounds
  the sub-tile (sx <= tx, sy <= ty); it no longer cuts the grid. A block
  stages the halo'd window of each input into shared memory, evaluates
  each producer over the sub-tile's footprint into shared memory
  (recomputing the halo that neighbouring sub-tiles also compute), and
  writes the sub-tile. The members' buffers share
  shared memory by liveness, each free after the phase of its last reader.
- Planning for Hopper: the sub-tile (up to 256x128) and the threads of a
  block (128, 256, 512 or 1024) are plan fields, chosen within the 227 KB a
  block can take by a rule (`_plan_score`) that weighs the halo the
  sub-tile recomputes (the operations over the members' footprints and
  the window bytes staged, per output) and its phases' barriers against
  the blocks and warps an SM keeps resident (from the shared memory and
  the threads), with the wave quantization of the grid and the overlap of
  its shifted last column and row. `__launch_bounds__(threads,
  min_blocks)` grants `_REGS` registers a thread, so that the deep groups
  do not spill. The rule's three constants are fitted to a sweep on the
  card (`tools/k1_walk_sweep.py`, PERF.md).
- Staging: a window that lies inside its input's realized region is
  copied row by row, 16 bytes at a time by cp.async where the strides
  allow (else 8 or 4), the head and tail of each row by element; its rows
  sit in shared memory at the same phase modulo the copy unit as in device
  memory, `pitch()` elements apart. Only a block whose window leaves the
  region gathers it element by element, replicating the edge. The choice is
  made per block, from its origin, in the kernel.
- Band walk (the counterpart of the JAX planner's band split, gated there
  by the probe `_bandsplit_ok`): where one tile spans the whole x extent,
  there are at least 4 row bands and the row loop is parallel(), the plan
  records a band walk (`band_walk`), as the JAX planner decides its band
  split. A block still computes one sub-tile with one window buffer: the
  JAX planner's double-buffered window DMA has no counterpart, and no TMA.
- A member stored at a loop that encloses its compute loop (`store_at`,
  `store_root`) is computed whole in every sub-tile, as any other member:
  the port does not carry it (the reference's sliding window) because the
  carry measured slower on the H100 (PERF.md).

The source of one group is emitted by this module: the member Funcs' point
expressions and their footprint arithmetic, with the fixed helpers in
`csrc/group_kernel.cuh`. It is built once by `nvcc` into
`build/kernels/<hash>.so` (a plain C interface, loaded with ctypes; the hash
is of the source) and exports `launch_<hash>(...)`, which takes device
pointers, strides, extents, the output region and the grid as plain
integers, and returns `cudaGetLastError()`.

Beside the kernel: `run_plain`, the plain PyTorch version of the same plan
(the same windows and boxes, evaluated with eval_torch, runs of sub-tile
rows at once where that computes what each sub-tile would). A wrapper
takes it only for tensors that lie on the CPU; on a CUDA tensor it
launches the kernel or raises. `launches` counts launches.

Planning follows the JAX planner (member checks, footprints, window
classification). A schedule the plan cannot take (a consumer with an
update or a tuple value, an update it cannot compute in the kernel, a
window that does not track the tile, the shared-memory limit) is evaluated
whole-array by the caller, as the JAX package does; the reason is counted
in `rejects`. A build or launch failure never falls back: it raises.

Update definitions and tuple values of members (the JAX kernel's,
`pallas_group.py:721-736`, `:842-869`, `:1521-1547`). A member may hold a
tuple: each value has its own buffer in its own type, one after another in
the member's region of shared memory (`_Stage.value_off`), an undef value
zeros. Its updates are computed in the kernel where each writes at the
member's pure vars, in order, and reads the member only there (else the
plan rejects: "non-aligned update write", "shifted self-read update"): a
point's updates then read no other point's, so each thread runs them on
the points it owns, its state in locals, before the barrier that ends the
member's phase (`_PointEmitter.update`). An update without an RDom is one
step; one with an RDom a loop over it, r.x innermost, its bounds
constants, that skips the points where its predicates do not hold. A step
computes every value from the state before it, then writes them all
(tuple semantics). The footprint pass visits each update's values and
predicates over the member's box widened by its RDom, so the inputs only
an update reads (compositing's layers and `ops` table) are staged. The
plain version applies each update with `updates.apply_update` over the
member's box. The consumer keeps one definition and one value, and an input of several
values stays rejected ("multi-value input"): no app reads one in a group.

A read whose index depends on data (bilateral_grid's z plane, a lookup
table) is clamped into its buffer in the kernel, as the plain version's
gather clips it into the window: no read leaves shared memory, even where
the data leave the bounds the plan staged.

Div-indexed windows: an input read at (x + c) / d under the tile (the
pyramid upsample, the grid slice) is staged as the window of its own
coordinates, starting at floor(x0 / d) + off (floor division, `hl_div`, in
the kernel) with one element of slack, and the read indexes it at
(x + c) / d - lo: the repeat is index arithmetic. This replaces the JAX
package's in-kernel repeat (`eval_jnp._kernel_repeat`, a one-hot MXU
product or a broadcast + reshape, gated by the probes
`pallas_group._repeat_kernel_ok` and `eval_jnp._reshape_repeat_ok`); its
host pre-expansion of lane-axis windows (`Realized.prediv`) and partial
pre-expansion of sublane-axis ones work around Mosaic's layout rules and
have no counterpart. A member whose footprint is div-indexed is rejected,
as the JAX planner derives div symbols for inputs only. The last column
and row of sub-tiles may sit at any origin phase modulo d, and the plan
checks that the staged window holds the footprint at every phase.

Point functions take the arithmetic, casts, selects, the libm functions,
lerp, saturating_cast, absd, the bit counts (popcount, clz, ctz), division
rounded toward zero, recip, reinterpret and Let (its value bound once to a
local the body reads by name) (`csrc/group_kernel.cuh`), over every integer
type, f32, f64 and the 16-bit floats (float16 and bfloat16: each operation
computed in f32 and rounded back to the type, as the plain version's torch
ops do; their operations count at the f32 rate). print, print_when, require
and random make the plan reject the group, which then runs whole-array: the
first three read their values back to the host, and random draws over the
whole evaluated shape, which a sub-tile is not.

An inline Reduce (sum, product, maximum, minimum, argmax, argmin; the
JAX kernel evaluates it through eval_jnp._eval_reduce, its footprint pass
widening the scope by the RDom, `pallas_group.py:302-311`) is a loop over
its RDom, r.x innermost, whose bounds are constants, with an accumulator in
the value's type that starts at the identity (`_PointEmitter._reduce`).
The plain version folds in the same order (eval_torch's `fold`), so the
two agree bit for bit.

The plan records the schedule's async()/ring_buffer() request
(`async_requested`, as the JAX planner does); K1 has no second window
buffer to answer it with.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import itertools
import math
from typing import Dict, List, Optional, Tuple

import torch

from .. import expr as E
from .. import spans
from ..expr import CompileError
from ..bounds import BoundsEngine, Box, Interval
from ..eval_torch import (Axis, Ctx, Realized, edge_window, eval_array,
                          full_shape, pow_is_square, reduce_identity)
from ..func import Func
from ..htypes import Type, compute_dtype, torch_dtype
from ..schedule import ForType
from ..updates import (_aligned_self, _is_undef, apply_update,
                       find_self_calls)
from ..visitors import find_variables, mutate, substitute
from ..visitors import walk as walk_expr
from . import build as _build

# ---------------------------------------------------------------------------
# counters and records
# ---------------------------------------------------------------------------

launches = 0                               # kernel launches on a CUDA tensor
rejects: collections.Counter = collections.Counter()   # reason -> count
last_plan: Optional[dict] = None           # the most recent group's plan
# per consumer name, its last plan's record or its last reject reason (the
# pipeline report's lowering line)
plans_by_name: Dict[str, dict] = {}
rejects_by_name: Dict[str, str] = {}
builds = _build.builds                     # (library key, nvcc seconds)

# the planner's search: sub-tiles up to these, threads a block among these,
# within the shared memory a block can take (the rule: `_plan_score`)
_SMEM_LIMIT = 227 * 1024
_SMEM_SM = 228 * 1024          # an SM's shared memory, 1 KB of it per block
_SUB_X = (256, 128, 64, 32)
_SUB_Y = (128, 64, 32, 16, 8, 4, 2, 1)
_THREADS = (128, 256, 512, 1024)
_SMS = 132                      # SMs of an H100 SXM
# registers a thread that __launch_bounds__ grants: min_blocks is capped so
# that 65536 / (threads * min_blocks) stays at least this
_REGS = 64
# the rule's constants, fitted to the sweep on the card (PERF.md): the
# resident warps an SM needs to reach its rate, what one staged byte costs
# in f32-operation slots (the ratio of the card's f32 rate to its memory
# rate), and what one phase of a block costs beyond its work (a barrier
# and the loop around it, in slots of the SM)
_WARPS_FULL = 32
_BYTE_OPS = 10.0
_SYNC = 512000.0

_CSRC = _build.CSRC


class GroupUnsupported(Exception):
    """The plan cannot take this schedule: the group is evaluated
    whole-array instead."""


class _SubTileNotMultiple(GroupUnsupported):
    """A div-indexed window's d does not divide this sub-tile: the planner
    tries the other sub-tiles."""


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# schedule queries (ported from the JAX planner)
# ---------------------------------------------------------------------------

def find_tile(f: Func) -> Optional[Tuple[str, int, Optional[str], int]]:
    """(xdim_name, tx, ydim_name, ty) from the stage-0 splits, or a 1-D
    (xdim, tx, None, 0)."""
    if not f._defs:
        return None
    tiles = []
    for sp in f._defs[0].schedule.splits:
        if sp.kind != "split":
            continue
        factor = sp.factor
        if isinstance(factor, E.Expr):
            if not isinstance(factor, E.IntImm):
                continue
            factor = factor.value
        if any(v.name == sp.old for v in f._defs[0].args):
            tiles.append((sp.old, int(factor)))
    if not tiles:
        return None
    if len(tiles) == 1:
        return (tiles[0][0], tiles[0][1], None, 0)
    (a, ta), (b, tb) = tiles[0], tiles[1]
    return (a, ta, b, tb)


def group_members(f: Func, graph) -> List[Func]:
    """Funcs scheduled compute_at(f, ...), in dependency order."""
    return [g for g in graph.funcs
            if g._fschedule.compute_level.kind == "at"
            and g._fschedule.compute_level.func is f]


def _is_inline(t) -> bool:
    if not isinstance(t, Func) or t.is_extern():
        return False
    if len(t._defs) > 1 or len(t._defs[0].values) > 1:
        return False
    lvl = t._fschedule.compute_level
    return not (lvl.is_root() or lvl.kind == "at")


class _Footprints:
    """Required boxes of every stage a group reads, over a consumer box."""

    def __init__(self, engine: BoundsEngine):
        self.engine = engine
        self.boxes: Dict[int, Box] = {}
        self.targets: Dict[int, object] = {}
        # (target id, dim) -> the divisors d of its reads (1: not x / d)
        self.divs: Dict[Tuple[int, int], set] = {}

    def visit(self, e, scope):
        if isinstance(e, E.Call):
            for a in e.args:
                self.visit(a, scope)
            t = e.target
            ivs = [self.engine.bounds(a, scope) for a in e.args]
            box = self.boxes.setdefault(id(t), Box.empty(len(ivs)))
            self.targets[id(t)] = t
            for i, iv in enumerate(ivs):
                if not iv.is_bounded():
                    raise GroupUnsupported(
                        f"unbounded footprint of {getattr(t, 'name', '?')}")
                box.union_dim(i, iv)
                self.divs.setdefault((id(t), i), set()).add(
                    _index_divisor(e.args[i]))
            return
        if isinstance(e, E.Let):
            # (pallas_group.py:296-301) the body sees the value's bounds
            self.visit(e.value, scope)
            child = dict(scope)
            child[e.name] = self.engine.bounds(e.value, scope)
            self.visit(e.body, child)
            return
        if isinstance(e, E.Reduce):
            # (pallas_group.py:302-311) the value, `where` and the RDom's
            # predicates see each RVar over its whole range
            child = self.engine.rdom_scope(e.rdom, scope)
            for c in [e.value, e.where] + list(e.rdom.predicates):
                if c is not None:
                    self.visit(c, child)
            return
        for c in e.children():
            self.visit(c, scope)


def _index_divisor(a) -> int:
    """d of an index written (v + c) / d + e with d > 1 a constant, else
    1."""
    while isinstance(a, E.Binary) and a.op in ("add", "sub"):
        if isinstance(a.b, E.IntImm):
            a = a.a
        elif a.op == "add" and isinstance(a.a, E.IntImm):
            a = a.b
        else:
            break
    if isinstance(a, E.Binary) and a.op == "div" and \
            isinstance(a.b, E.IntImm) and a.b.value > 1:
        return a.b.value
    return 1


def _match_clamp(a):
    """max(min(e, HI), LO) / min(max(e, LO), HI) -> (e, LO, HI) or None."""
    if not isinstance(a, E.Binary):
        return None
    if a.op == "max" and isinstance(a.a, E.Binary) and a.a.op == "min":
        return a.a.a, a.b, a.a.b
    if a.op == "max" and isinstance(a.b, E.Binary) and a.b.op == "min":
        return a.b.a, a.a, a.b.b
    if a.op == "min" and isinstance(a.a, E.Binary) and a.a.op == "max":
        return a.a.a, a.a.b, a.b
    if a.op == "min" and isinstance(a.b, E.Binary) and a.b.op == "max":
        return a.b.a, a.b.b, a.a
    return None


def _static_val(e2, engine):
    try:
        iv = engine.bounds(e2, {})
    except Exception:
        return None
    if iv.is_bounded() and iv.lo == iv.hi:
        return int(iv.lo)
    return None


def _inline_expand(expr):
    """Substitute single-value inline Funcs (boundary-condition wrappers)
    into their call sites, so their clamps are visible to the strip pass."""
    def fn(e2):
        if isinstance(e2, E.Call) and _is_inline(e2.target):
            t = e2.target
            binds = {v.name: a for v, a in zip(t._defs[0].args, e2.args)}
            return mutate(substitute(t._defs[0].values[e2.value_index],
                                     binds), fn)
        return None

    return mutate(expr, fn)


def _strip_boundary_clamps(expr, ext_boxes, engine):
    """Elide clamp-to-realized-bounds on reads of the group's inputs
    (repeat_edge): the staged window replicates the edge over the clamped-
    out range, so clamp(i, min, max) and the raw i select identical values.
    This keeps footprints shift-covariant at the edge tiles."""
    def fn(e2):
        if not isinstance(e2, E.Call) or id(e2.target) not in ext_boxes:
            return None
        mins_g, shape_g = ext_boxes[id(e2.target)]
        nd_t = len(shape_g)
        a2 = list(e2.args)
        changed = False
        for j, a in enumerate(a2[:nd_t]):
            m = _match_clamp(a)
            if m is None:
                continue
            inner, lo_e, hi_e = m
            lo_v, hi_v = _static_val(lo_e, engine), _static_val(hi_e, engine)
            gmin, gext = int(mins_g[j]), int(shape_g[nd_t - 1 - j])
            if lo_v == gmin and hi_v == gmin + gext - 1:
                a2[j] = inner
                changed = True
        if changed:
            return E.Call(e2.target, a2, e2.value_index, e2.dtype)
        return None

    return mutate(expr, fn)


def _ctx_resolver(ctx0: Ctx):
    def resolver(name, args):
        if name == "param":
            return ctx0.params.get(id(args[0]))
        real = ctx0.realizations.get(id(args[0]))
        if real is None:
            return None
        if name == "buffer_min":
            return real.mins[args[1]]
        a = real.arrays[0]
        return a.shape[a.ndim - 1 - args[1]]
    return resolver


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

_CTYPES = {
    "uint8": "uint8_t", "uint16": "uint16_t", "uint32": "uint32_t",
    "uint64": "uint64_t", "int8": "int8_t", "int16": "int16_t",
    "int32": "int32_t", "int64": "int64_t", "float16": "hl_f16",
    "bfloat16": "hl_bf16", "float32": "float", "float64": "double",
    "bool": "bool",
}


def _is_half(t: Type) -> bool:
    """float16 or bfloat16: stored in 16 bits, each operation computed in
    f32 and rounded back (csrc/group_kernel.cuh hl_round16)."""
    return t.is_float() and t.bits == 16


def ctype(t: Type) -> str:
    if t.is_bool():
        return "bool"
    name = f"{t.code}{t.bits}" if t.code != "bfloat" else "bfloat16"
    if name not in _CTYPES:
        raise GroupUnsupported(f"type {t} in a group (not ported)")
    return _CTYPES[name]


def itemsize(t: Type) -> int:
    return 1 if t.is_bool() else t.bits // 8


class _Stage:
    """A buffer in shared memory: an input window (func None) or a member
    over its footprint. dims[j] = (kind, d, off, ext): kind 'x'/'y' tracks
    the sub-tile origin x0/y0 (lo = floor(origin / d) + off; d > 1 only for
    an input window read at (x + c) / d), 's' is static (lo = off, d = 1).
    A member holds one buffer for each value of its tuple, in the value's
    type, one after another (`value_off`), and its update definitions as
    (Definition, stripped values, stripped predicates)."""

    def __init__(self, name, target, type_, dims, values=(), updates=()):
        self.name = name
        self.target = target
        self.type = type_
        self.dims = dims
        # the stripped point exprs of a member's pure definition, one per
        # value (undef: zeros); `value` is the first (None for a window)
        self.values = list(values)
        self.value = self.values[0] if self.values else None
        self.types = [v.dtype for v in self.values] or [type_]
        self.updates = list(updates)
        self.smem_off = 0
        self.index = 0

    def exprs(self) -> list:
        """Every expr a member evaluates: its values, then each update's
        values and predicates."""
        return self.values + [e for _d, vals, preds in self.updates
                              for e in vals + preds]

    def pitch(self) -> int:
        """Elements from one row (dim-0 run) of the buffer to the next. A
        window's rows are padded to a multiple of 16 bytes plus 16, so that
        each row can sit at its source's phase modulo the copy unit."""
        ext0 = self.dims[0][3]
        if self.value is not None:
            return ext0
        return (_aligned(ext0 * itemsize(self.type)) + 16) \
            // itemsize(self.type)

    def value_off(self, k: int) -> int:
        """Bytes from a member's buffer to that of its value k."""
        n = math.prod(e for _k, _d, _o, e in self.dims)
        return sum(_aligned(n * itemsize(t)) for t in self.types[:k])

    def nbytes(self) -> int:
        if len(self.types) > 1:
            return self.value_off(len(self.types))
        return self.pitch() * math.prod(e for _k, _d, _o, e in self.dims[1:]) \
            * itemsize(self.type)

    def data_bytes(self) -> int:
        """The elements' bytes, without the rows' padding."""
        return math.prod(e for _k, _d, _o, e in self.dims) \
            * itemsize(self.type)


class GroupPlan:
    """Everything the kernel and its plain version need, fixed at plan
    time; only pointers, strides, realized bounds and the output region
    are passed at launch. A block computes one sub-tile: the grid is the
    `ncx` x `ncy` sub-tiles over the output extent, and a block's shared
    memory (`smem_bytes`) its windows' bytes then its members'."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def record(self) -> dict:
        return {"func": self.f.name, "tile": (self.tx, self.ty),
                "sub_tile": (self.sx, self.sy),
                "sub_tiles": (self.ncx, self.ncy),
                "grid": (self.ncx, self.ncy),
                "smem_bytes": self.smem_bytes, "threads": self.threads,
                "min_blocks": self.min_blocks, "model": self.model,
                "band_walk": self.band_walk,
                "async_requested": self.async_requested,
                "part": self.part,
                "windows": [w.name for w in self.windows],
                "div_windows": {w.name: [(k, d) for k, d, _o, _e in w.dims
                                         if d > 1]
                                for w in self.windows
                                if any(d > 1 for _k, d, _o, _e in w.dims)},
                "members": [m.name for m in self.members]}


def band_walk_wanted(f: Func, xdim: str, ydim: Optional[str], ntx: int,
                     nty: int) -> bool:
    """The JAX planner's band-split condition (`pallas_group.py:759-790`,
    gated there by the probe `_bandsplit_ok`): one tile spans the whole x
    extent, there are at least 4 row bands, and the outer var of y's split
    is parallel() while that of x's is not. The TPU remaps such a grid so
    that each of its two cores walks its bands in order with the next
    band's windows in flight; K1 records the decision, and its blocks
    compute one sub-tile each as in any other plan."""
    if ydim is None or ntx != 1 or nty < 4:
        return False
    s0 = f._defs[0].schedule
    outer_of = {sp.old: sp.outer for sp in s0.splits if sp.kind == "split"}
    par = {d.var for d in s0.dims if d.for_type == ForType.PARALLEL}
    return outer_of.get(ydim) in par and outer_of.get(xdim) not in par


def _aligned(n: int) -> int:
    return _cdiv(n, 16) * 16


def _member_layout(members: List["_Stage"], out_value) -> int:
    """Place the members' buffers by liveness (first fit): member k is
    written in phase k + 1 and its buffer is free after the phase of its
    last reader, a later member or the output (phase len + 1); a barrier
    ends every phase. Sets each member's smem_off (from the member base)
    and returns the bytes of the member region."""
    phase = {id(m.target): k + 1 for k, m in enumerate(members)}
    last = dict(phase)

    def reads(value, ph):
        def fn(e):
            if isinstance(e, E.Call) and id(e.target) in last:
                last[id(e.target)] = max(last[id(e.target)], ph)
        walk_expr(value, fn)
    for k, m in enumerate(members):
        for e in m.exprs():
            reads(e, k + 1)
    reads(out_value, len(members) + 1)
    placed: List[Tuple[int, int, int]] = []       # (off, end, last phase)
    top = 0
    for m in members:
        size = _aligned(m.nbytes())
        live = sorted((o, e) for o, e, lp in placed
                      if lp >= phase[id(m.target)])
        off = 0
        for o, e in live:
            if off + size <= o:
                break
            off = max(off, e)
        m.smem_off = off
        placed.append((off, off + size, last[id(m.target)]))
        top = max(top, off + size)
    return top


def plan_group(f: Func, box: Box, ctx0: Ctx, graph,
               sub_tile: Optional[Tuple[int, int]] = None,
               threads: Optional[int] = None,
               part: str = "all") -> GroupPlan:
    """The plan of f's group over `box`. The sub-tile and the threads a
    block are the rule's choice (`_plan_score`) unless given (the sweep);
    `part` "stage" or "compute" emits a kernel that only stages the windows
    or only computes (from whatever shared memory holds), for timing the
    two apart."""
    if part not in ("all", "stage", "compute"):
        raise ValueError(f"part {part!r}")
    if len(f._defs) != 1 or len(f._defs[0].values) != 1:
        raise GroupUnsupported("multi-def/multi-value consumer")
    tile = find_tile(f)
    if tile is None:
        raise GroupUnsupported("no tile() on consumer")
    xdim, tx, ydim, ty = tile
    members = group_members(f, graph)
    for m in members:
        if m._fschedule.debug_file:
            raise GroupUnsupported(f"member {m.name}: debug_to_file")
        # (pallas_group.py:721-736) an update is computed in the kernel
        # where it writes at the pure vars, in order, and reads the member
        # only there: each point's updates then depend on that point alone
        for d in m._defs[1:]:
            if not all(isinstance(a, E.Variable) and a.name == v.name
                       for a, v in zip(d.args, m._defs[0].args)):
                raise GroupUnsupported(
                    f"member {m.name}: non-aligned update write")
            for v in list(d.values) + list(d.predicates):
                if not all(_aligned_self(c, d.args)
                           for c in find_self_calls(v, m)):
                    raise GroupUnsupported(
                        f"member {m.name}: shifted self-read update")
        mdims = {v.name for v in m._defs[0].args}
        if xdim not in mdims or (ydim is not None and ydim not in mdims):
            raise GroupUnsupported(
                f"member {m.name}: does not share tiled dims")
    member_ids = {id(m) for m in members} | {id(f)}
    dims = [v.name for v in f._defs[0].args]
    if xdim not in dims or (ydim is not None and ydim not in dims):
        raise GroupUnsupported("tile of a non-pure dim")
    xi = dims.index(xdim)
    yi = dims.index(ydim) if ydim is not None else None
    mins, extents = list(box.mins()), list(box.extents())
    tx = min(tx, extents[xi])
    ty = min(ty, extents[yi]) if yi is not None else 1

    engine = BoundsEngine(resolver=_ctx_resolver(ctx0))
    ext_boxes = {tid: (r.mins, tuple(r.arrays[0].shape))
                 for tid, r in ctx0.realizations.items()
                 if tid not in member_ids}

    def strip(v):
        return _strip_boundary_clamps(_inline_expand(v), ext_boxes, engine)

    svalue = strip(f._defs[0].values[0])
    # each member's stripped pure values, and its updates' (Definition,
    # values, predicates)
    mvals = {id(m): [strip(v) for v in m._defs[0].values] for m in members}
    mupds = {id(m): [(d, [strip(v) for v in d.values],
                      [strip(p) for p in d.predicates])
                     for d in m._defs[1:]] for m in members}

    def footprints(scope):
        """Boxes of the members and the inputs, consumers first. An update
        reads over the member's box, widened by its RDom where it has one
        (pallas_group.py:842-869), so the inputs that only an update reads
        are staged too."""
        fp = _Footprints(engine)
        fp.visit(svalue, scope)
        for m in reversed(members):
            bb = fp.boxes.get(id(m))
            if bb is None or not bb.defined():
                raise GroupUnsupported(f"member {m.name} is not read")
            sc = {v.name: bb.dims[i] for i, v in enumerate(m._defs[0].args)}
            for v in mvals[id(m)]:
                fp.visit(v, sc)
            for d, vals, preds in mupds[id(m)]:
                sc_d = engine.rdom_scope(d.rdom, sc) if d.rdom else sc
                for e in vals + preds:
                    fp.visit(e, sc_d)
        return fp

    full = {dims[i]: Interval(mins[i], mins[i] + extents[i] - 1)
            for i in range(len(dims))}
    fp_g = footprints(full)

    def sub_scope(x0, sx, y0, sy):
        sc = dict(full)
        sc[xdim] = Interval(x0, x0 + sx - 1)
        if ydim is not None:
            sc[ydim] = Interval(y0, y0 + sy - 1)
        return sc

    _check_fold_storage(members, footprints(sub_scope(0, tx, 0, ty)))

    def stages_for(sx, sy):
        """Classify every dim of every member and input footprint of a
        sub-tile (sx, sy) by how it moves when the sub-tile moves: not at
        all (static), by sx or sy (tracks the tile), or, for an input, by
        sx / d or sy / d (div-indexed: the pyramid upsample's x / 2, d
        read off the index expression). A div-indexed window is staged
        with one element of slack, so that it also covers the footprint at
        origins that are not multiples of d (the shifted-inwards last tile
        and sub-tile): floor((x0 + c) / d) lies in [floor(x0 / d) +
        floor(c / d), that + 1]."""
        fp_t = footprints(sub_scope(0, sx, 0, sy))
        fp_x = footprints(sub_scope(sx, sx, 0, sy))
        fp_y = footprints(sub_scope(0, sx, sy, sy)) if ydim else fp_t

        stages = []
        for tid, t in fp_g.targets.items():
            name = getattr(t, "name", "?")
            if tid == id(f):
                raise GroupUnsupported("consumer reads itself")
            if tid not in member_ids and tid not in ctx0.realizations:
                raise GroupUnsupported(f"unrealized input {name}")
            bt, bx, by, bg = (fp_t.boxes[tid], fp_x.boxes[tid],
                              fp_y.boxes[tid], fp_g.boxes[tid])
            sdims = []
            for j in range(len(bt.dims)):
                dx = bx.dims[j].lo - bt.dims[j].lo
                dy = by.dims[j].lo - bt.dims[j].lo if ydim else 0
                same = (bx.dims[j].extent() == bt.dims[j].extent()
                        and by.dims[j].extent() == bt.dims[j].extent())
                lo, ext = int(bt.dims[j].lo), int(bt.dims[j].extent())
                # d of a div-indexed dim: every read of it is (v + c) / d
                ds = fp_t.divs[(tid, j)]
                d = next(iter(ds)) if len(ds) == 1 else 1
                for s, b in ((sx, bx), (sy, by)):
                    if d > 1 and s % d and (b.dims[j].lo, b.dims[j].hi) != (
                            bt.dims[j].lo, bt.dims[j].hi):
                        raise _SubTileNotMultiple(
                            f"window dim {j} of {name}: d = {d} does not "
                            f"divide the sub-tile {s}")
                if dx == 0 and dy == 0 and same:
                    sdims.append(("s", 1, int(bg.dims[j].lo),
                                  int(bg.dims[j].extent())))
                elif dx == sx and dy == 0 and same:
                    sdims.append(("x", 1, lo, ext))
                elif dy == sy and dx == 0 and same and ydim:
                    sdims.append(("y", 1, lo, ext))
                elif d > 1 and dx * d == sx and dy == 0 and same:
                    sdims.append(("x", d, lo, ext))
                elif d > 1 and dy * d == sy and dx == 0 and same and ydim:
                    sdims.append(("y", d, lo, ext))
                else:
                    raise GroupUnsupported(
                        f"window dim {j} of {name}: mixed/partial tile "
                        "dependence")
                if sdims[-1][1] > 1:
                    if tid in member_ids:
                        # the JAX planner derives div symbols for inputs
                        # only: a member so read is evaluated whole-array
                        raise GroupUnsupported(
                            f"member {name}: div-indexed footprint")
                    k, d, _lo, _ext = sdims[-1]
                    sdims[-1] = (k, d, lo, ext + 1)
            if tid in member_ids:
                stages.append(_Stage(t.name, t, mvals[tid][0].dtype, sdims,
                                     mvals[tid], mupds[tid]))
            else:
                real = ctx0.realizations[tid]
                stages.append(_Stage(name, t, t.output_type(0), sdims))
                if len(real.arrays) != 1:
                    raise GroupUnsupported(f"multi-value input {name}")
        return stages

    ntx = _cdiv(extents[xi], tx)
    nty = _cdiv(extents[yi], ty) if yi is not None else 1
    band_walk = band_walk_wanted(f, xdim, ydim, ntx, nty)
    ext_x = extents[xi]
    ext_y = extents[yi] if yi is not None else 1
    other = math.prod(e for i, e in enumerate(extents) if i not in (xi, yi))
    out_type = f._defs[0].values[0].dtype

    def layout(stages):
        """-> (window bytes, member bytes), placing the members' buffers
        (`_member_layout`)."""
        win = sum(_aligned(s.nbytes()) for s in stages if s.value is None)
        by_id = {id(s.target): s for s in stages}
        mem = _member_layout([by_id[id(m)] for m in members
                              if id(m) in by_id], svalue)
        return win, mem

    def candidates(sx, sy, stages):
        """The rule's terms of sub-tile (sx, sy) at each thread count."""
        smem = sum(layout(stages))
        if smem > _SMEM_LIMIT:
            return []
        out_pts = sx * sy * other
        ops = _weighted(point_ops(svalue)) * out_pts + sum(
            _weighted(member_ops(st)) * math.prod(
                e for _k, _d, _o, e in st.dims)
            for st in stages if st.value is not None)
        free = _weighted(point_ops(svalue)) * out_pts + sum(
            _weighted(member_ops(s)) * sx * sy * math.prod(
                e for k, _d, _o, e in s.dims if k == "s")
            for s in stages if s.value is not None)
        staged = sum(s.data_bytes() for s in stages if s.value is None) \
            + out_pts * itemsize(out_type)
        ncx, ncy = _cdiv(ext_x, sx), _cdiv(ext_y, sy)
        # outputs the grid computes per output of the extent: the last
        # column and row, shifted inwards, recompute their overlap
        cover = ncx * ncy * sx * sy / (ext_x * ext_y)
        out = []
        for nt in _THREADS:
            if nt > out_pts and nt > _THREADS[0]:
                continue
            bps = min(_SMEM_SM // (smem + 1024), 2048 // nt, 32)
            terms = dict(sub_tile=(sx, sy), threads=nt, smem_bytes=smem,
                         blocks_per_sm=bps, recompute=ops / max(free, 1),
                         ops_per_out=ops / out_pts,
                         bytes_per_out=staged / out_pts, blocks=ncx * ncy,
                         phases=len(members) + 2, out_pts=out_pts,
                         cover=cover)
            terms["score"] = _plan_score(terms)
            out.append(terms)
        return out

    def search():
        """Every sub-tile within the limit at every thread count, the best
        by `_plan_score` first. -> (candidates, stages of each sub-tile)."""
        cands, stages_of, failed = [], {}, None
        if sub_tile is not None:
            xs, ys = [min(sub_tile[0], tx)], [min(sub_tile[1], ty)]
        else:
            xs = sorted({min(s, tx) for s in _SUB_X})
            ys = sorted({min(s, ty) for s in _SUB_Y}) if ydim else [1]
        for sx in xs:
            for sy in ys:
                try:
                    stages = stages_for(sx, sy)
                except _SubTileNotMultiple as ex:
                    failed = failed or ex
                    continue
                stages_of[(sx, sy)] = stages
                cands += [c for c in candidates(sx, sy, stages)
                          if threads is None or c["threads"] == threads]
        if not stages_of:
            raise failed
        cands.sort(key=plan_key)
        return cands, stages_of

    cands, stages_of = search()
    if not cands:
        raise GroupUnsupported(
            f"shared-memory limit: no sub-tile of {tx}x{ty} fits "
            f"{_SMEM_LIMIT} bytes" + (f" at {threads} threads"
                                      if threads else ""))
    best = cands[0]
    sx, sy = best["sub_tile"]
    stages = stages_of[(sx, sy)]
    _check_div_cover(stages, footprints, sub_scope, sx, sy)
    # the windows still along y first, then those that move with the
    # sub-tile's row: the order of the record and the launch arguments
    windows = sorted((s for s in stages if s.value is None),
                     key=lambda s: any(k == "y" for k, _d, _o, _e in s.dims))
    by_id = {id(s.target): s for s in stages}
    ordered = windows + [by_id[id(m)] for m in members if id(m) in by_id]
    window_bytes, member_bytes = layout(stages)
    off = 0
    for k, s in enumerate(ordered):
        s.index = k
        if s.value is None:
            s.smem_off = off
            off += _aligned(s.nbytes())
    ctype(out_type)
    for s in ordered:
        for t in s.types:
            ctype(t)
    plan = GroupPlan(
        f=f, value=svalue, out_type=out_type, dims=dims, xi=xi, yi=yi,
        mins=mins, extents=extents, tx=tx, ty=ty, sx=sx, sy=sy,
        ntx=ntx, nty=nty, ncx=_cdiv(ext_x, sx), ncy=_cdiv(ext_y, sy),
        threads=best["threads"],
        min_blocks=max(1, min(best["blocks_per_sm"],
                              65536 // (best["threads"] * _REGS))),
        model={k: best[k] for k in ("score", "recompute", "ops_per_out",
                                     "bytes_per_out", "blocks_per_sm")},
        candidates=cands, part=part,
        windows=windows, members=ordered[len(windows):],
        window_bytes=window_bytes, member_bytes=member_bytes,
        smem_bytes=window_bytes + member_bytes, band_walk=band_walk,
        async_requested=_async_requested(f, members))
    plan.source, plan.symbol, plan.arg_types = emit_source(plan, ctx0)
    return plan


_FREE_INTRIN = {"param", "buffer_min", "buffer_extent", "likely",
                "strict_float", "undef"}
# operations one call of an intrinsic counts where not 1: clz of a width
# below 32 corrects its 32-bit count, ctz is __ffs and the select of 0,
# the divisions rounded toward zero guard their divisor (an integer
# division itself counts as one, though the card has no divide unit)
_INTRIN_OPS = {"clz": 2, "ctz": 2, "div_rtz": 2, "mod_rtz": 2}
# intrinsics the kernel does not take: print, print_when and require read
# their values back to the host, and random draws over the whole evaluated
# shape (per tile it would give other values); a group that holds one is
# evaluated whole-array
_WHOLE_ARRAY_INTRIN = {"print", "print_when", "require", "random"}


def point_ops(value) -> Tuple[int, int]:
    """(f32, integer) operations one point of `value` (an expr, or a list
    of exprs computed together: a tuple's values) does on its data. The
    coordinate arithmetic of a read's indices is not counted unless the
    index depends on data; an operation is counted by its operands' type (a
    float comparison is an f32 operation), an intrinsic as `_INTRIN_OPS`
    says, a bit cast not at all; a shared subexpression once."""
    n, seen = [0, 0], set()

    def visit(e):
        if id(e) in seen:
            return
        seen.add(id(e))
        if isinstance(e, E.Call):
            for a in e.args:
                if _reads_data(a):
                    visit(a)
            return
        if isinstance(e, E.Reduce):
            # the value's operations (and the predicates') at every point
            # of the RDom, and one combine a point in the value's type
            pts = math.prod(rdom_extent(rv) for rv in e.rdom.dims)
            for c in [e.value, e.where] + list(e.rdom.predicates):
                if c is not None:
                    f32, i = point_ops(c)
                    n[0] += f32 * pts
                    n[1] += i * pts
            n[0 if e.value.dtype.is_float() else 1] += pts
            return
        if isinstance(e, list):
            for c in e:
                visit(c)
            return
        if isinstance(e, E.Select) and not find_variables(e.cond) and \
                not _reads_data(e.cond):
            # a constant condition (a mux at a bound RVar): the branch it
            # takes
            try:
                c = bool(eval_array(e.cond, Ctx(0, {}, {}, {}, {}, "cpu"))
                         .reshape(()).item())
            except (CompileError, KeyError, TypeError):
                c = None
            if c is not None:
                visit(e.true_value if c else e.false_value)
                return
        t, k = None, 1
        if isinstance(e, E.Binary):
            t = e.a.dtype
        elif isinstance(e, E.Select):
            t = e.true_value.dtype
        elif isinstance(e, E.Intrin) and e.name not in _FREE_INTRIN:
            first = e.args[0] if e.args else None     # random's is a tag
            t = first.dtype if isinstance(first, E.Expr) else e.dtype
            k = _INTRIN_OPS.get(e.name, 1)
        elif isinstance(e, E.Not):
            t = e.dtype
        if t is not None:
            n[0 if t.is_float() else 1] += k
        for c in e.children():
            visit(c)
    visit(value)
    return n[0], n[1]


def rdom_points(d) -> int:
    """The points of an update's RDom (1 for an update without one)."""
    return math.prod(rdom_extent(rv) for rv in d.rdom.dims) if d.rdom \
        else 1


def member_ops(st: "_Stage", passing=None) -> Tuple[int, int]:
    """(f32, integer) operations of one point of a member: its values
    (`point_ops`), then each update's predicates at every point of its
    RDom and its values at every point, or, where `passing` is given (a
    run's data, `update_passing`), at the RDom points in `passing[k]` for
    update k, each with its RVars bound: a mux at an RVar then counts the
    branch it takes."""
    n = list(point_ops(st.values))
    for k, (d, vals, preds) in enumerate(st.updates):
        pts = rdom_points(d)
        f, i = point_ops(preds)
        n[0], n[1] = n[0] + f * pts, n[1] + i * pts
        if passing is None:
            f, i = point_ops(vals)
            n[0], n[1] = n[0] + f * pts, n[1] + i * pts
            continue
        for p in passing[k]:
            f, i = point_ops(_at_point(vals, d, p))
            n[0], n[1] = n[0] + f, n[1] + i
    return n[0], n[1]


def _at_point(exprs, d, point) -> list:
    """exprs with the RVars of d's RDom bound to `point`, rebuilt together
    (one memo), so that the subexprs they share stay shared."""
    binds = {rv.name: E.IntImm(Type("int", 32), v)
             for rv, v in zip(d.rdom.dims, point)} if d.rdom else {}
    memo: dict = {}
    return [mutate(e, lambda n: binds.get(n.name) if isinstance(
        n, E.Variable) else None, memo) for e in exprs]


def update_passing(st: "_Stage", realz: dict, params: dict,
                   dev) -> List[List[Tuple[int, ...]]]:
    """The RDom points of each of a member's updates whose predicates pass
    on a run's data (`realz`: id -> Realized of the inputs they read, as
    `group_calls` gives them): each predicate evaluated with the RVars
    bound (compositing's `r0 == ops[r1]` reads the `ops` table). A
    predicate that reads a pure var, whose answer then differs from point
    to point of the member, counts as passing. Points in RDom order, dim 0
    fastest."""
    out = []
    for d, _vals, preds in st.updates:
        dims = list(d.rdom.dims) if d.rdom else []
        ranges = [range(rv.rmin.value, rv.rmin.value + rdom_extent(rv))
                  for rv in reversed(dims)]
        pts = []
        for rev in itertools.product(*ranges):
            point = tuple(reversed(rev))
            ok = True
            for e in _at_point(preds, d, point):
                if not find_variables(e):
                    v = eval_array(e, Ctx(0, {}, {}, realz, params, dev))
                    ok = ok and bool(v.reshape(()).item())
            if ok:
                pts.append(point)
        out.append(pts)
    return out


def rdom_extent(rv) -> int:
    """The extent of an RVar in a group: a constant (the kernel's loop
    bounds are compiled in)."""
    if not isinstance(rv.rextent, E.IntImm) or \
            not isinstance(rv.rmin, E.IntImm):
        raise GroupUnsupported(f"RDom {rv.name} in a group: its bounds are "
                               "not constants")
    return max(0, rv.rextent.value)


def _weighted(ops: Tuple[int, int]) -> int:
    """f32-operation slots: an integer operation issues on half the lanes."""
    return ops[0] + 2 * ops[1]


def _plan_score(c: dict) -> float:
    """The rule: time per output, in f32-operation slots. The sub-tile's
    operations with its halo and its phases (`_SYNC` slots each) on one
    side, its staged bytes (`_BYTE_OPS` slots each) on the other, overlap
    as far as other resident blocks can run while one waits: max(a, b) +
    min(a, b) / resident. That over the share of an SM's rate its resident
    warps reach (`_WARPS_FULL` reach it all; blocks resident by shared
    memory and threads: the registers are not known before the build),
    times the outputs the grid computes per output (the shifted last column
    and row overlap the ones before) and the grid's wave quantization (the
    last wave of blocks may leave SMs idle)."""
    bps = c["blocks_per_sm"]
    waves = _cdiv(c["blocks"], _SMS * bps)
    resident = min(bps, _cdiv(c["blocks"], _SMS))
    warps = resident * c["threads"] / 32
    a = c["ops_per_out"] + _SYNC * c["phases"] / (c["out_pts"] * resident)
    b = _BYTE_OPS * c["bytes_per_out"]
    work = max(a, b) + min(a, b) / resident
    return work / min(1.0, warps / _WARPS_FULL) * c["cover"] \
        * waves * _SMS * bps / c["blocks"]


def plan_key(c: dict):
    """The planner's order of candidates: the rule, then the larger
    sub-tile, then fewer threads."""
    return (_plan_score(c), -c["sub_tile"][0] * c["sub_tile"][1],
            c["threads"])


def _async_requested(f: Func, members) -> bool:
    """async() or ring_buffer() on a member or the consumer, as the JAX
    planner records it (pallas_group.py:1216-1219). A record only: K1 has
    no second window buffer, and stages each sub-tile's windows (by
    cp.async where the strides allow) before it computes."""
    return any(g._fschedule.is_async or bool(g._fschedule.ring_buffer_extent)
               for g in list(members) + [f])


def _check_fold_storage(members, fp_tile):
    """fold_storage(var, k) of a member whose footprint over one tile
    spans more than k entries of var raises, as the JAX planner does
    (pallas_group.py:1111-1125; the reference's
    halide_error_fold_factor_too_small, StorageFolding.cpp:219-264)."""
    for m in members:
        box = fp_tile.boxes.get(id(m))
        names = [v.name for v in m._defs[0].args]
        for sd in m._fschedule.storage_dims:
            if box is None or sd.var not in names:
                continue
            need = int(box.dims[names.index(sd.var)].extent())
            if sd.fold_factor is not None and need > sd.fold_factor:
                raise CompileError(
                    f"fold_storage: {m.name} requires {need} live entries "
                    f"of {sd.var} per tile, but the fold factor is "
                    f"{sd.fold_factor} (the reference fails with "
                    "halide_error_fold_factor_too_small)")


def _check_div_cover(stages, footprints, sub_scope, sx, sy):
    """The staged div-indexed windows hold the footprint of a sub-tile at
    every origin phase, not only at the multiples of d they were classified
    at: checked at each phase (x0 mod d, y0 mod d). d is read off the
    index, so this fails only where its numerator does not move one for one
    with the origin (a member's box that grows, a clamp), and the plan is
    rejected."""
    per = {"x": 1, "y": 1}
    for s in stages:
        for k, d, _o, _e in s.dims:
            if d > 1:
                per[k] = per[k] * d // math.gcd(per[k], d)
    if per == {"x": 1, "y": 1}:
        return
    for rx in range(per["x"]):
        for ry in range(per["y"]):
            if rx == ry == 0:
                continue
            fp = footprints(sub_scope(rx, sx, ry, sy))
            for s in stages:
                box = fp.boxes[id(s.target)]
                for j, ((lo, ext), iv) in enumerate(zip(
                        _stage_box(s, rx, ry), box.dims)):
                    if iv.lo < lo or iv.hi > lo + ext - 1:
                        raise GroupUnsupported(
                            f"window dim {j} of {s.name}: footprint at "
                            f"origin phase ({rx}, {ry}) leaves the staged "
                            "window")


def try_group(f: Func, box: Box, ctx0: Ctx, graph,
              cache: dict) -> Optional[Realized]:
    """Compute f and its compute_at producers through the group kernel (a
    CUDA tensor) or its plain version (a CPU tensor). Returns None when the
    plan cannot take the schedule; the caller then evaluates the group
    whole-array. `cache` keeps the plan of each Func across realizes."""
    with spans.span(spans.K1, f.name):
        plan = cache.get(id(f))
        if plan is None:
            try:
                with spans.span(spans.K1_PLAN, f.name):
                    plan = plan_group(f, box, ctx0, graph)
            except GroupUnsupported as ex:
                rejects[str(ex)] += 1
                rejects_by_name[f.name] = str(ex)
                plans_by_name.pop(f.name, None)
                cache[id(f)] = False
                return None
            # nothing the record reads changes once the plan is made
            plan.recorded = plan.record()
            cache[id(f)] = plan
        elif plan is False:
            return None
        note_plan(f.name, plan.recorded)
        inputs = [ctx0.realizations[id(w.target)].arrays[0]
                  for w in plan.windows]
        real_mins = [ctx0.realizations[id(w.target)].mins
                     for w in plan.windows]
        out = compute(plan, inputs, real_mins, ctx0.params, ctx0.device)
        return Realized((out,), plan.mins, f.name)


def note_plan(name: str, recorded: dict) -> None:
    """Record a group's plan (`recorded`, its `record()`) as the last plan
    and as the plan of its consumer `name`, as each launch of the group,
    or replay of one (plan_graph), leaves them."""
    global last_plan
    last_plan = plans_by_name[name] = recorded
    rejects_by_name.pop(name, None)


# where set, `compute` hands each plan to this callable and computes
# nothing (`planning`)
_PLANNING = [None]


@contextlib.contextmanager
def planning(keep):
    """While it holds, a realize plans its groups and computes none of
    them: each group's output is left uninitialized, and keep(plan,
    windows' realized mins, params) sees each plan (the lowered program of
    generator's pysource, the plans an exported program names)."""
    old = _PLANNING[0]
    _PLANNING[0] = keep
    try:
        yield
    finally:
        _PLANNING[0] = old


def compute(plan: GroupPlan, inputs, real_mins, params: dict,
            dev: torch.device) -> torch.Tensor:
    """The group's output: the kernel on the card, its plain version on the
    CPU. While a program is exported, through the custom op that names the
    kernel (export_ops); where autograd asks for a gradient (an input, or a
    traced Param, that requires one), through `_GroupGrad`, whose forward
    is the same launch or plain version."""
    from . import export_ops
    if _PLANNING[0] is not None:
        _PLANNING[0](plan, real_mins, params)
        return torch.empty(tuple(reversed(plan.extents)),
                           dtype=torch_dtype(plan.out_type), device=dev)
    if export_ops.exporting():
        key = export_ops.group_key(plan)
        export_ops.plans[key] = (plan, real_mins, params)
        return export_ops.group_op(list(inputs), key)
    traced = [pid for pid, v in params.items()
              if isinstance(v, torch.Tensor) and v.requires_grad]
    if torch.is_grad_enabled() and (traced or any(
            t.requires_grad for t in inputs)):
        return _GroupGrad.apply(plan, real_mins, params, traced, dev,
                                *inputs, *(params[p] for p in traced))
    if dev.type == "cpu":
        return run_plain(plan, inputs, real_mins, params, dev)
    return launch(plan, inputs, real_mins)


class _GroupGrad(torch.autograd.Function):
    """K1 under autograd. The forward launches the kernel (or runs the
    plain version on the CPU) without a graph; the backward recomputes the
    plain version (torch ops, on the same device) with a graph and takes
    its vector-Jacobian product. No kernel of the JAX package has a
    backward kernel either: `jax.grad` differentiates its Pallas kernel's
    body."""

    @staticmethod
    def forward(ctx, plan, real_mins, params, traced, dev, *tensors):
        n = len(plan.windows)
        ctx.plan, ctx.real_mins, ctx.params = plan, real_mins, params
        ctx.traced, ctx.dev, ctx.n = traced, dev, n
        ctx.save_for_backward(*tensors)
        vals = dict(params)
        vals.update({p: t.detach() for p, t in zip(traced, tensors[n:])})
        inputs = [t.detach() for t in tensors[:n]]
        if dev.type == "cpu":
            return run_plain(plan, inputs, real_mins, vals, dev)
        return launch(plan, inputs, real_mins)

    @staticmethod
    def backward(ctx, grad_out):
        tensors = [t.detach().requires_grad_(t.requires_grad)
                   for t in ctx.saved_tensors]
        vals = dict(ctx.params)
        vals.update(zip(ctx.traced, tensors[ctx.n:]))
        wanted = [t for t in tensors if t.requires_grad]
        with torch.enable_grad():
            out = run_plain(ctx.plan, tensors[:ctx.n], ctx.real_mins, vals,
                            ctx.dev)
            got = iter(torch.autograd.grad(out, wanted, grad_out,
                                           allow_unused=True))
        grads = [next(got) if t.requires_grad else None for t in tensors]
        return (None, None, None, None, None, *grads)


def group_calls(pipeline, device=None, replan=None) -> list:
    """Every group of `pipeline`'s last realize, in the order it ran them,
    made again so that the kernel can be held against its plain version
    (the tests, the chip check): each plan comes from the realize's planned
    graph, and the groups' inputs from evaluating every stored stage
    whole-array by eval_torch over the box that realize gave it
    (`pipeline.last_realize`). With `replan` (plan -> a list of keyword
    arguments of `plan_group`: sub_tile, threads, part), each group is
    planned again once for each of them, in its place (the sweep); a
    variant the plan cannot take is left out. -> [(plan, inputs,
    real_mins, params, realizations)]."""
    from ..pipeline import _evaluate_func, last_realize
    from .stage_kernel import declining
    dev, planned, g, realz, params, stored = last_realize(pipeline, device)
    plans = [p for p in planned["groups"].values() if p]
    ctx0 = Ctx(0, {}, {}, realz, params, dev)
    # the groups' inputs as eval_torch makes them, with no stage kernel
    with declining("a group's inputs made again"):
        for fn, box in stored:
            realz[id(fn)] = _evaluate_func(fn, box, ctx0)
    if replan is not None:
        variants = []
        for p in plans:
            for kw in replan(p):
                try:
                    variants.append(plan_group(
                        p.f, planned["boxes"][id(p.f)], ctx0, g, **kw))
                except GroupUnsupported:
                    pass
        plans = variants
    return [(plan, [realz[id(w.target)].arrays[0] for w in plan.windows],
             [realz[id(w.target)].mins for w in plan.windows], params, realz)
            for plan in plans]


def group_call(pipeline, device=None):
    """The last group of `pipeline`'s last realize (`group_calls`)."""
    return group_calls(pipeline, device)[-1]


# ---------------------------------------------------------------------------
# the plain PyTorch version of the plan
# ---------------------------------------------------------------------------

def _origins(plan: GroupPlan, rows=None):
    """Sub-tile origins (x0, y0) of every block, as the kernel computes
    them: the sub-tiles of the output extent, the last column and row
    shifted inwards. `rows` keeps the sub-tile rows it holds (indices along
    y), where given."""
    xi, yi = plan.xi, plan.yi
    for by in range(plan.ncy):
        if rows is not None and by not in rows:
            continue
        y0 = 0
        if yi is not None:
            y0 = min(plan.mins[yi] + by * plan.sy,
                     plan.mins[yi] + plan.extents[yi] - plan.sy)
        for bx in range(plan.ncx):
            yield min(plan.mins[xi] + bx * plan.sx,
                      plan.mins[xi] + plan.extents[xi] - plan.sx), y0


def plain_rows(plan: GroupPlan, rows) -> List[int]:
    """Indices, from the output's y min, of the output rows that the sub-
    tile rows `rows` write (a plan with a y dim)."""
    return sorted({y0 - plan.mins[plan.yi] + i
                   for _x0, y0 in _origins(plan, rows)
                   for i in range(plan.sy)})


def _stage_box(s: _Stage, x0: int, y0: int):
    """[(lo, ext)] of a stage for the sub-tile at (x0, y0), as the kernel
    computes it (floor division for a div-indexed dim)."""
    return [(off + (x0 // d if k == "x" else y0 // d if k == "y" else 0),
             ext) for k, d, off, ext in s.dims]


def _tracks_by_data(plan: GroupPlan) -> bool:
    """A read in the group indexes a dim of a window or member that moves
    with the sub-tile by a value that depends on data: its clip into the
    buffer then depends on the sub-tile."""
    by_id = {id(s.target): s for s in plan.windows + plan.members}
    hit = [False]

    def fn(e):
        s = by_id.get(id(e.target)) if isinstance(e, E.Call) else None
        if s is not None and any(s.dims[j][0] != "s" and _reads_data(a)
                                 for j, a in enumerate(e.args)):
            hit[0] = True
    for v in [plan.value] + [x for m in plan.members for x in m.exprs()]:
        walk_expr(v, fn)
    return hit[0]


def _plain_runs(plan: GroupPlan, rows=None):
    """The boxes the plain version evaluates, as (first, last) sub-tile
    origins: each run of consecutive sub-tile rows (all of them, or those
    in `rows`) is one box from its first sub-tile to its last. A point's
    value depends only on its coordinates and the windows' contents at
    coordinates fixed relative to it, and a window's content at a
    coordinate is the same in every sub-tile's window (the input there, or
    its edge replicated), so a run computes what its sub-tiles compute
    one by one; the shifted-inwards last sub-tiles' overlap is computed
    once. Where `_tracks_by_data`, each sub-tile is its own box."""
    origins = list(_origins(plan, rows))
    if _tracks_by_data(plan):
        return [(o, o) for o in origins]
    runs, start = [], None
    for k, o in enumerate(origins):
        start = o if start is None else start
        nxt = origins[k + 1] if k + 1 < len(origins) else None
        # a run ends before a sub-tile row that does not follow this one
        # (the y origins move by at most sy from row to row)
        if nxt is None or (nxt[1] != o[1] and nxt[1] - o[1] > plan.sy):
            runs.append((start, o))
            start = None
    return runs


def run_plain(plan: GroupPlan, inputs, real_mins, params: dict,
              dev: torch.device, rows=None) -> torch.Tensor:
    """The same plan as the kernel, in torch: windows gathered with edge
    replication, members and the output evaluated with eval_torch over the
    boxes of runs of sub-tiles (`_plain_runs`; each sub-tile's box where a
    read's clip depends on the sub-tile), in the same storage types, each
    member's updates applied in order (updates.apply_update). `params`
    maps id(Param) to its value. With `rows` (sub-tile row indices), only
    those sub-tiles are evaluated, and the rest of the output is left
    unwritten (`plain_rows` gives the output rows they cover)."""
    n = len(plan.dims)
    out = torch.empty(tuple(reversed(plan.extents)),
                      dtype=torch_dtype(plan.out_type), device=dev)

    def box(s, first, last):
        """[(lo, ext)] of stage s over the sub-tiles first..last."""
        a, b = _stage_box(s, *first), _stage_box(s, *last)
        return [(lo, hb + eb - lo) for (lo, _e), (hb, eb) in zip(a, b)]

    for first, last in _plain_runs(plan, rows):
        realz: Dict[int, Realized] = {}
        for w, arr, rmins in zip(plan.windows, inputs, real_mins):
            lohi = box(w, first, last)
            realz[id(w.target)] = Realized(
                (edge_window(arr, w.type, rmins, lohi),),
                [lo for lo, _ in lohi], w.name)

        def context(fn, lohi, realizations):
            axes = {v.name: Axis(v.name, i, lo, ext)
                    for i, (v, (lo, ext)) in enumerate(
                        zip(fn._defs[0].args, lohi))}
            return Ctx(len(lohi), axes, {}, realizations, params, dev,
                       fold=True)

        def evaluate_over(fn, value, lohi, dtype):
            ctx = context(fn, lohi, realz)
            shape = full_shape(ctx, list(ctx.axes.values()))
            if _is_undef(value):
                return torch.zeros(shape, dtype=dtype, device=dev)
            return eval_array(value, ctx).expand(shape).to(dtype)

        for m in plan.members:
            lohi = box(m, first, last)
            mins = [lo for lo, _ in lohi]
            # while updates run, the values stay in their compute dtypes,
            # as pipeline._evaluate_func keeps them
            dts = [compute_dtype(t) if m.updates else torch_dtype(t)
                   for t in m.types]
            cur = [evaluate_over(m.target, v, lohi, dt)
                   for v, dt in zip(m.values, dts)]
            if m.updates:          # an update may write them in place
                cur = [a.clone(memory_format=torch.contiguous_format)
                       for a in cur]
            # (pallas_group.py:1531-1547) each update over the member's
            # box, the self-reads seeing the state before it
            for d, vals, preds in m.updates:
                ctx = context(m.target, lohi, dict(realz))
                ctx.realizations[id(m.target)] = Realized(cur, mins, m.name)
                d2 = d.replaced(values=tuple(vals),
                                predicates=list(preds))
                cur = apply_update(m.target, d2, cur, ctx)
            realz[id(m.target)] = Realized(
                tuple(a.to(torch_dtype(t)) for a, t in zip(cur, m.types)),
                mins, m.name)
        lohi = []
        for i in range(n):
            if i == plan.xi:
                lohi.append((first[0], last[0] + plan.sx - first[0]))
            elif i == plan.yi:
                lohi.append((first[1], last[1] + plan.sy - first[1]))
            else:
                lohi.append((plan.mins[i], plan.extents[i]))
        tile = evaluate_over(plan.f, plan.value, lohi,
                             torch_dtype(plan.out_type))
        out[tuple(slice(lo - plan.mins[i], lo - plan.mins[i] + ext)
                  for i, (lo, ext) in reversed(list(enumerate(lohi))))] = tile
    return out


# ---------------------------------------------------------------------------
# source emission
# ---------------------------------------------------------------------------

def _cname(name: str) -> str:
    return "v_" + "".join(c if c.isalnum() else "_" for c in name)


def _field(s: "_Stage") -> str:
    return f"s{s.index}_" + "".join(c if c.isalnum() else "_"
                                    for c in s.name)


def _vfield(s: "_Stage", k: int) -> str:
    """The Tile field of a member's value k (its first value: _field)."""
    return _field(s) if k == 0 else f"{_field(s)}_v{k}"


def _zero(t: Type) -> str:
    return _float_lit(0.0, t) if t.is_float() else _int_lit(0, t)


def _reads_data(e) -> bool:
    """e reads a Func or an input (its value depends on data)."""
    hit = [False]

    def fn(c):
        hit[0] = hit[0] or isinstance(c, E.Call)
    walk_expr(e, fn)
    return hit[0]


def _float_lit(v: float, t: Type) -> str:
    if _is_half(t):
        # the value rounded to the type (as the plain version's constant
        # tensor is), written as the f32 literal of that value
        v16 = torch.tensor(v, dtype=torch_dtype(t)).float().item()
        return f"hl_round16<{ctype(t)}>({_float_lit(v16, Type('float', 32))})"
    if t.bits == 32:
        import numpy as np
        v32 = float(np.float32(v))
        if math.isnan(v32):
            return "__builtin_nanf(\"\")"
        if math.isinf(v32):
            return "__builtin_inff()" if v32 > 0 else "(-__builtin_inff())"
        return float(v32).hex() + "f"
    if math.isnan(v):
        return "__builtin_nan(\"\")"
    if math.isinf(v):
        return "__builtin_inf()" if v > 0 else "(-__builtin_inf())"
    return float(v).hex()


def _int_lit(v: int, t: Type) -> str:
    if t.is_bool():
        return "true" if v else "false"
    ct = ctype(t)
    suffix = "ULL" if t.is_uint() else "LL"
    return f"(({ct}){v}{suffix})"


_MATH_F = {"sqrt", "exp", "log", "floor", "ceil", "trunc", "sin", "cos",
           "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "asinh",
           "acosh", "atanh", "erf", "pow", "atan2"}


class _PointEmitter:
    """Emits the point function of one stage as SSA statements."""

    def __init__(self, stages_by_id: Dict[int, _Stage], ctx0: Ctx,
                 scope: Dict[str, str]):
        self.stages = stages_by_id
        self.ctx0 = ctx0
        self.scope = scope
        self.lines: List[str] = []
        self.memo: Dict[int, str] = {}
        # a member's updates: (id of the member, the locals holding the
        # state of its values), which its aligned self-reads read
        self.state: Optional[Tuple[int, List[str]]] = None

    def update(self, d, vals, preds, types) -> None:
        """One update of the member whose state is `self.state`: a loop
        over its RDom (r.x innermost, the bounds constants) or one step.
        A point where the predicates hold computes every value from the
        state before the step, then writes them all (tuple semantics); an
        undef value is left as it was. The write and every self-read are
        at the point's own coordinates (the plan's gate), so no point
        depends on another's."""
        dims = list(d.rdom.dims) if d.rdom is not None else []
        k = len(self.lines)
        rv = [f"u{k}_{i}" for i in range(len(dims))]
        for i in reversed(range(len(dims))):
            lo, ext = dims[i].rmin.value, rdom_extent(dims[i])
            self.lines.append(f"  for (int {rv[i]} = {lo}; {rv[i]} < "
                              f"{lo + ext}; ++{rv[i]}) {{")
        scope, memo = self.scope, self.memo
        self.scope = dict(scope, **{dm.name: r for dm, r in zip(dims, rv)})
        # what the step computes reads the state: forgotten after it
        self.memo = {} if any(dm.name in scope for dm in dims) else dict(memo)
        try:
            conds = [self.val(p) for p in preds]
            if conds:
                self.lines.append("  if (" + " && ".join(
                    f"(bool){c}" for c in conds) + ") {")
            new = [(j, self.let(t, f"hl_cast<{ctype(t)}>({self.val(v)})"))
                   for j, (v, t) in enumerate(zip(vals, types))
                   if not _is_undef(v)]
            self.lines += [f"  {self.state[1][j]} = {n};" for j, n in new]
            if conds:
                self.lines.append("  }")
        finally:
            self.scope, self.memo = scope, memo
        self.lines += ["  }"] * len(dims)

    def let(self, t: Type, rhs: str) -> str:
        name = f"t{len(self.lines)}"
        self.lines.append(f"  const {ctype(t)} {name} = {rhs};")
        return name

    def val(self, e) -> str:
        if isinstance(e, E.Variable):       # by name: a Let may rebind it
            return self._val(e)
        hit = self.memo.get(id(e))
        if hit is None:
            hit = self._val(e)
            self.memo[id(e)] = hit
        return hit

    def _let(self, e: E.Let) -> str:
        """The value once, as a local the body reads by name (not
        substituted into the body, which would repeat its work). What the
        body computes is forgotten after it: it may read the name."""
        v = self.val(e.value)
        scope, memo = self.scope, self.memo
        self.scope = dict(scope, **{e.name: v})
        self.memo = {} if e.name in scope else dict(memo)
        try:
            return self.val(e.body)
        finally:
            self.scope, self.memo = scope, memo

    def _val(self, e) -> str:
        if isinstance(e, E.IntImm):
            return _int_lit(e.value, e.dtype)
        if isinstance(e, E.FloatImm):
            return _float_lit(e.value, e.dtype)
        if isinstance(e, E.Variable):
            if e.name not in self.scope:
                raise GroupUnsupported(f"free variable {e.name}")
            return self.scope[e.name]
        if isinstance(e, E.Cast):
            return self.let(e.dtype, f"hl_cast<{ctype(e.dtype)}>("
                                     f"{self.val(e.value)})")
        if isinstance(e, E.Binary):
            return self._binary(e)
        if isinstance(e, E.Not):
            return self.let(e.dtype, f"!{self.val(e.a)}")
        if isinstance(e, E.Select):
            c, t, f = (self.val(e.cond), self.val(e.true_value),
                       self.val(e.false_value))
            return self.let(e.dtype, f"{c} ? {t} : {f}")
        if isinstance(e, E.Call):
            return self._read(e)
        if isinstance(e, E.Intrin):
            return self._intrin(e)
        if isinstance(e, E.Reinterpret):
            return self.let(e.dtype, f"hl_reinterpret<{ctype(e.dtype)}, "
                                     f"{ctype(e.value.dtype)}>("
                                     f"{self.val(e.value)})")
        if isinstance(e, E.Let):
            return self._let(e)
        if isinstance(e, E.Reduce):
            return self._reduce(e)
        raise GroupUnsupported(f"{type(e).__name__} in a kernel")

    def _combine(self, op: str, t: Type, a: str, b: str) -> str:
        """a op b in Type t, a 16-bit float computed in f32 and rounded."""
        if _is_half(t):
            return (f"hl_round16<{ctype(t)}>(hl_{op}<float>(hl_f32({a}), "
                    f"hl_f32({b})))")
        return f"hl_{op}<{ctype(t)}>({a}, {b})"

    def _reduce(self, e: E.Reduce) -> str:
        """A loop over the RDom, r.x innermost, its bounds constants. The
        accumulator, in the value's type, starts at the identity (an empty
        RDom leaves it there) and combines each point whose predicates and
        `where` hold. argmax/argmin keep the best value and its
        coordinates; a point where the predicates fail takes the identity
        (as the plain version's), and a point replaces the best where it is
        more extreme or a NaN, or, on a tie, where it comes first with RDom
        dim 0 the most significant (`hl_arg_better`): eval_torch's order.
        An argmax or argmin over an empty RDom raises, as eval_torch's."""
        dims = e.rdom.dims
        n = len(dims)
        vt = e.value.dtype
        ct = ctype(vt)
        k = len(self.lines)
        arg = e.op in ("argmax", "argmin")
        if arg and not all(rdom_extent(d) for d in dims):
            raise CompileError(f"{e.op} over an empty RDom")
        ident = reduce_identity(e.op, vt)
        ident = (_float_lit(float(ident), vt) if vt.is_float()
                 else _int_lit(int(ident), vt))
        acc, rv = f"acc{k}", [f"r{k}_{i}" for i in range(n)]
        self.lines.append(f"  {ct} {acc} = {ident};")
        if arg:
            self.lines.append(f"  int {acc}_c[{n}] = {{"
                              + ", ".join(str(rd.rmin.value) for rd in dims)
                              + "};")
        for i in reversed(range(n)):
            ext = rdom_extent(dims[i])
            lo = dims[i].rmin.value
            self.lines.append(f"  for (int {rv[i]} = {lo}; {rv[i]} < "
                              f"{lo + ext}; ++{rv[i]}) {{")
        scope, memo = self.scope, self.memo
        self.scope = dict(scope, **{d.name: r for d, r in zip(dims, rv)})
        self.memo = {} if any(d.name in scope for d in dims) else dict(memo)
        try:
            v = self.val(e.value)
            conds = [self.val(c) for c in list(e.rdom.predicates)
                     + ([e.where] if e.where is not None else [])]
            cond = " && ".join(f"(bool){c}" for c in conds)
            if arg:
                if cond:
                    v = self.let(vt, f"({cond}) ? {v} : ({ct}){ident}")
                first = "false"
                for i in reversed(range(n)):
                    first = (f"({rv[i]} < {acc}_c[{i}] || ({rv[i]} == "
                             f"{acc}_c[{i}] && {first}))")
                a, b = ((f"hl_f32({v})", f"hl_f32({acc})") if _is_half(vt)
                        else (v, acc))
                big = "true" if e.op == "argmax" else "false"
                self.lines.append(
                    f"  if (hl_arg_better<{big}>({a}, {b}, {first})) {{ "
                    f"{acc} = {v}; "
                    + " ".join(f"{acc}_c[{i}] = {rv[i]};" for i in range(n))
                    + " }")
            else:
                op = {"sum": "add", "product": "mul", "maximum": "max",
                      "minimum": "min"}[e.op]
                upd = f"{acc} = {self._combine(op, vt, acc, v)};"
                self.lines.append(f"  if ({cond}) {upd}" if cond
                                  else f"  {upd}")
        finally:
            self.scope, self.memo = scope, memo
        self.lines += ["  }"] * n
        if arg and e.value_index < n:
            return self.let(e.dtype, f"({ctype(e.dtype)}){acc}_c["
                                     f"{e.value_index}]")
        return self.let(e.dtype, acc)

    def _half(self, t: Type, rhs: str) -> str:
        """An f32 result rounded to the 16-bit float type t."""
        return self.let(t, f"hl_round16<{ctype(t)}>({rhs})")

    def _binary(self, e: E.Binary) -> str:
        a, b = self.val(e.a), self.val(e.b)
        t = e.a.dtype
        ct = ctype(t)
        helpers = {"add": "hl_add", "sub": "hl_sub", "mul": "hl_mul",
                   "div": "hl_div", "mod": "hl_mod", "min": "hl_min",
                   "max": "hl_max", "shl": "hl_shl", "shr": "hl_shr"}
        if _is_half(t):
            # computed in f32, rounded back after every operation, as
            # eval_torch's ops on 16-bit tensors: mod as its a - b *
            # floor(a / b), three roundings
            a, b = f"hl_f32({a})", f"hl_f32({b})"
            if e.op == "mod":
                q = self._half(t, f"{a} / {b}")
                m = self._half(t, f"{b} * floorf(hl_f32({q}))")
                return self._half(t, f"{a} - hl_f32({m})")
            if e.op in helpers and e.op not in ("shl", "shr"):
                return self._half(t, f"{helpers[e.op]}<float>({a}, {b})")
            ct = "float"
        elif e.op in helpers:
            return self.let(e.dtype, f"{helpers[e.op]}<{ct}>({a}, {b})")
        syms = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">",
                "ge": ">=", "and": "&&", "or": "||", "bitand": "&",
                "bitor": "|", "bitxor": "^"}
        if e.op in syms:
            return self.let(e.dtype, f"({ctype(e.dtype)})({a} {syms[e.op]} "
                                     f"{b})")
        raise GroupUnsupported(f"binary op {e.op} of {t}")

    def _intrin(self, e: E.Intrin) -> str:
        n = e.name
        if n in ("likely", "strict_float"):
            return self.val(e.args[0])
        half = _is_half(e.dtype)
        if n == "pow" and pow_is_square(e):         # x * x, as eval_torch
            a = self.val(e.args[0])
            return self.let(e.dtype, self._combine("mul", e.dtype, a, a))
        if n in _MATH_F or (n == "round" and e.dtype.is_float()):
            if not e.dtype.is_float():
                raise GroupUnsupported(f"{n} of {e.dtype}")
            fn = "rint" if n == "round" else n
            fn += "" if e.dtype.bits == 64 else "f"
            if half:
                args = ", ".join(f"hl_f32({self.val(a)})" for a in e.args)
                return self._half(e.dtype, f"{fn}({args})")
            args = ", ".join(self.val(a) for a in e.args)
            return self.let(e.dtype, f"{fn}({args})")
        if n == "abs":
            at = e.args[0].dtype
            v = self.val(e.args[0])
            if _is_half(at):
                v = f"hl_abs<float>(hl_f32({v}))"
            else:
                v = f"hl_abs<{ctype(at)}>({v})"
            return self.let(e.dtype, f"hl_cast<{ctype(e.dtype)}>({v})")
        if n == "absd":
            at = ctype(e.args[0].dtype)
            a, b = self.val(e.args[0]), self.val(e.args[1])
            return self.let(e.dtype, f"hl_absd<{ctype(e.dtype)}, {at}>("
                                     f"{a}, {b})")
        if n == "saturating_cast":
            v, at = self.val(e.args[0]), e.args[0].dtype
            if half:                        # float -> float: a plain cast
                return self.let(e.dtype, f"hl_cast<{ctype(e.dtype)}>({v})")
            if _is_half(at):
                v, at = f"hl_f32({v})", Type("float", 32)
            return self.let(e.dtype, "hl_saturating_cast<"
                                     f"{ctype(e.dtype)}, {ctype(at)}>({v})")
        if n == "bitnot":
            return self.let(e.dtype, f"({ctype(e.dtype)})(~"
                                     f"{self.val(e.args[0])})")
        if n == "lerp":
            return self._lerp(e)
        if n in ("popcount", "clz", "ctz"):
            at = e.args[0].dtype
            if not at.is_integer() or at.is_bool():
                raise GroupUnsupported(f"{n} of {at}")
            return self.let(e.dtype, f"hl_cast<{ctype(e.dtype)}>(hl_{n}<"
                                     f"{ctype(at)}>({self.val(e.args[0])}))")
        if n in ("div_rtz", "mod_rtz"):
            if _is_half(e.args[0].dtype):
                raise GroupUnsupported(f"{n} of {e.args[0].dtype}")
            a, b = self.val(e.args[0]), self.val(e.args[1])
            return self.let(e.dtype, f"hl_{n}<{ctype(e.args[0].dtype)}>("
                                     f"{a}, {b})")
        if n == "recip":
            if not e.dtype.is_float():
                raise GroupUnsupported(f"recip of {e.dtype}")
            if half:
                return self._half(e.dtype,
                                  f"1.0f / hl_f32({self.val(e.args[0])})")
            ct = ctype(e.dtype)
            return self.let(e.dtype, f"hl_div<{ct}>(({ct})1, "
                                     f"{self.val(e.args[0])})")
        if n in _WHOLE_ARRAY_INTRIN:
            raise GroupUnsupported(
                f"intrinsic {n} in a group: it runs whole-array")
        if n == "param":
            v = self.ctx0.params[id(e.args[0])]
            if isinstance(v, torch.Tensor):     # a traced Param's value
                v = v.detach().item()
            if e.dtype.is_float():
                return _float_lit(float(v), e.dtype)
            return _int_lit(int(v), e.dtype)
        if n in ("buffer_min", "buffer_extent"):
            real = self.ctx0.realizations.get(id(e.args[0]))
            if real is None:
                raise GroupUnsupported(f"{n} of an unbound buffer")
            a, i = real.arrays[0], e.args[1]
            v = real.mins[i] if n == "buffer_min" else a.shape[a.ndim - 1 - i]
            return _int_lit(int(v), e.dtype)
        raise GroupUnsupported(f"intrinsic {n} in a kernel")

    def _lerp(self, e: E.Intrin) -> str:
        """eval_torch's lerp, operation for operation: zero * (1 - w) +
        one * w (the build's -fmad=false keeps the products unfused), a
        uint weight over 2^bits - 1, a bool weight selecting, an integer
        result computed in f32 and rounded half to even (rint)."""
        zero, one, w = (self.val(a) for a in e.args)
        t, wt = e.dtype, e.args[2].dtype
        if wt.is_bool():
            return self.let(t, f"{w} ? {one} : {zero}")
        if wt.is_uint():
            f32 = Type("float", 32)
            w = self.let(f32, f"(float){w} / "
                              f"{_float_lit(float((1 << wt.bits) - 1), f32)}")
            wt = f32
        if not wt.is_float() or wt.bits not in (32, 64) or (
                t.is_float() and t.bits not in (32, 64)):
            raise GroupUnsupported(f"lerp of {t} by a {wt} weight")
        wide = 64 in (wt.bits, t.bits if t.is_float() else 32)
        ft = Type("float", 64 if wide else 32)
        cf = ctype(ft)
        w = self.let(ft, f"({cf}){w}")
        w1 = self.let(ft, f"hl_sub<{cf}>({_float_lit(1.0, ft)}, {w})")
        r = self.let(ft, f"hl_add<{cf}>(hl_mul<{cf}>(({cf}){zero}, {w1}), "
                         f"hl_mul<{cf}>(({cf}){one}, {w}))")
        if t.is_float():
            return self.let(t, f"({ctype(t)}){r}")
        rint = "rint" if wide else "rintf"
        return self.let(t, f"hl_cast<{ctype(t)}>({rint}({r}))")

    def _read(self, e: E.Call) -> str:
        """A read of a window or a member's value buffer. An index that
        depends on data (bilateral_grid's z) is clamped into the buffer,
        as the plain version's gather clips it: no read leaves the
        buffer, even where the bounds the plan staged were not the data's.
        A member's read of itself in its update is its state."""
        if self.state is not None and id(e.target) == self.state[0]:
            return self.state[1][e.value_index]
        s = self.stages.get(id(e.target))
        if s is None:
            raise GroupUnsupported(
                f"read of {getattr(e.target, 'name', '?')} in a kernel")
        if e.value_index >= len(s.types):
            raise GroupUnsupported(f"read of value {e.value_index} of "
                                   f"{s.name} in a kernel")
        idx, stride = [], 1
        for j, a in enumerate(e.args):
            av = self.val(a)
            lo = f"t.{_field(s)}_lo[{j}]"
            if _reads_data(a):
                av = (f"hl_min<int>(hl_max<int>((int){av}, {lo}), {lo} + "
                      f"{s.dims[j][3] - 1})")
            idx.append(f"({av} - {lo}) * {stride}")
            stride *= s.pitch() if j == 0 else s.dims[j][3]
        return self.let(s.types[e.value_index],
                        f"t.{_vfield(s, e.value_index)}"
                        f"[{' + '.join(idx)}]")


def emit_source(plan: GroupPlan, ctx0: Ctx):
    """-> (source, symbol, ctypes argtypes) of the plan's kernel."""
    stages = plan.windows + plan.members
    by_id = {id(s.target): s for s in stages}
    nd_out = len(plan.dims)
    L: List[str] = [
        "// Stencil-group kernel, emitted by halide_tpu_torch/ops/"
        "group_kernel.py",
        f"// consumer {plan.f.name}; members "
        f"{', '.join(m.name for m in plan.members) or '-'}; inputs "
        f"{', '.join(w.name for w in plan.windows) or '-'}",
        '#include "group_kernel.cuh"',
        "",
        "namespace {",
        "",
        f"constexpr int SX = {plan.sx};",
        f"constexpr int SY = {plan.sy};",
        f"constexpr int SMEM_MAX = {plan.smem_bytes};",
        f"constexpr int THREADS = {plan.threads};",
        f"constexpr int MIN_BLOCKS = {plan.min_blocks};",
        "constexpr bool STAGE = %s;"
        % ("false" if plan.part == "compute" else "true"),
        "constexpr bool COMPUTE = %s;"
        % ("false" if plan.part == "stage" else "true"),
        "",
        "// the shared-memory buffers of one sub-tile and their origins",
        "struct Tile {",
        "  int x0, y0;",
    ]
    for s in stages:
        for k, t in enumerate(s.types):
            L.append(f"  const {ctype(t)}* {_vfield(s, k)};")
        L.append(f"  int {_field(s)}_lo[{len(s.dims)}];")
        if s.value is None:
            L.append(f"  int {_field(s)}_ph;  // copy phase; -1: edge path")
    L += ["};", ""]
    # point functions: a member's computes each of its values at a point,
    # runs its updates on them, and stores them at element i of its
    # buffers; the output's returns its value
    for s in plan.members + [None]:
        fn = plan.f if s is None else s.target
        args = [v.name for v in fn._defs[0].args]
        em = _PointEmitter(by_id, ctx0, {a: _cname(a) for a in args})
        params = ", ".join(f"int {_cname(a)}" for a in args)
        if s is None:
            result = em.val(plan.value)
            t = ctype(plan.out_type)
            L.append(f"HL_FN {t} point_out(const Tile& t, {params}) {{")
            L += em.lines
            L += [f"  return hl_cast<{t}>({result});", "}", ""]
            continue
        res = [_zero(t) if _is_undef(v) else em.val(v)
               for v, t in zip(s.values, s.types)]
        bufs = [f"(({ctype(t)}*)t.{_vfield(s, k)})[i]"
                for k, t in enumerate(s.types)]
        if s.updates:
            state = [f"st{k}" for k in range(len(s.types))]
            em.lines += [f"  {ctype(t)} {n} = hl_cast<{ctype(t)}>({r});"
                         for n, t, r in zip(state, s.types, res)]
            em.state = (id(s.target), state)
            for d, vals, preds in s.updates:
                em.update(d, vals, preds, s.types)
            res = state
        em.lines += [f"  {b} = hl_cast<{ctype(t)}>({r});"
                     for b, t, r in zip(bufs, s.types, res)]
        L.append(f"HL_FN void point_{_field(s)}(const Tile& t, int i, "
                 f"{params}) {{")
        L += em.lines + ["}", ""]
    # runtime parameters
    L.append("struct Params {")
    for k, w in enumerate(plan.windows):
        L.append(f"  HlInput<{len(w.dims)}> in{k};")
    L += [f"  {ctype(plan.out_type)}* out;",
          f"  long long out_stride[{nd_out}];",
          f"  int out_min[{nd_out}];",
          f"  int out_ext[{nd_out}];",
          "};", ""]

    def walk_box(lines, ext, body):
        """for i in [tid, prod(ext)) step nth: c_d = coords(i)."""
        n = math.prod(ext)
        lines.append(f"    for (int i = tid; i < {n}; i += nth) {{")
        rem = "i"
        for d, e in enumerate(ext):
            if d == len(ext) - 1:
                lines.append(f"      const int c{d} = {rem};")
            else:
                lines.append(f"      const int c{d} = {rem} % {e};")
                if d + 1 < len(ext):
                    lines.append(f"      const int r{d} = {rem} / {e};")
                    rem = f"r{d}"
        lines += body
        lines.append("    }")

    # each window's extents, declared in every function that uses them (a
    # namespace-scope array's address cannot be taken in device code)
    exts = {k: "  const int ext%d[%d] = {%s};" % (
        k, len(w.dims), ", ".join(str(e) for _k, _d, _o, e in w.dims))
        for k, w in enumerate(plan.windows)}
    # the sub-tile (bx, by): origins, buffers (the windows first, the
    # members after them), window origins and each window's copy phase
    L += [
        "// Sub-tile (bx, by): column bx and row by of the sub-tile grid over",
        "// the output, the last column and row shifted inwards.",
        "HL_FN Tile tile_at(const Params& p, int bx, int by,",
        "                   unsigned char* smem) {",
        "  Tile t;",
        "  const int x0 = hl_shift_inwards(p.out_min[%d], p.out_ext[%d], SX, "
        "bx);" % (plan.xi, plan.xi),
    ]
    if plan.yi is not None:
        L.append("  const int y0 = hl_shift_inwards(p.out_min[%d], "
                 "p.out_ext[%d], SY, by);" % (plan.yi, plan.yi))
    else:
        L.append("  const int y0 = 0; (void)by;")
    L.append("  t.x0 = x0; t.y0 = y0;")
    for s in stages:
        cn, ct = _field(s), ctype(s.type)
        for j, (k, d, off, _e) in enumerate(s.dims):
            origin = {"x": "x0", "y": "y0", "s": ""}[k]
            if origin and d > 1:       # floor division, never C's `/`
                origin = f"hl_div<int>({origin}, {d})"
            base = f"{origin} + " if origin else ""
            L.append(f"  t.{cn}_lo[{j}] = {base}{off};")
        if s.value is not None:
            L += [f"  t.{_vfield(s, k)} = (const {ctype(t)}*)(smem + "
                  f"{plan.window_bytes + s.smem_off + s.value_off(k)});"
                  for k, t in enumerate(s.types)]
            continue
        k = plan.windows.index(s)
        L += ["  {", "  " + exts[k],
              f"    t.{cn}_ph = hl_window_phase<{ct}, {len(s.dims)}>("
              f"p.in{k}, t.{cn}_lo, ext{k});",
              f"    t.{cn} = (const {ct}*)(smem + {s.smem_off}) + "
              f"(t.{cn}_ph > 0 ? t.{cn}_ph : 0);", "  }"]
    L += ["  return t;", "}", ""]
    L += [
        "// Stage the windows of sub-tile (bx, by). Copies by cp.async stay",
        "// in flight until hl_async_wait().",
        "HL_FN void stage(const Params& p, int bx, int by, int tid, int nth,",
        "                 unsigned char* smem) {",
        "  const Tile t = tile_at(p, bx, by, smem);",
        "  (void)t; (void)tid; (void)nth;",
    ] + list(exts.values())
    for k, w in enumerate(plan.windows):
        cn, ct, nd = _field(w), ctype(w.type), len(w.dims)
        L.append(f"  hl_stage_window<{ct}, {nd}>(({ct}*)t.{cn}, t.{cn}_ph, "
                 f"{w.pitch()}, p.in{k}, t.{cn}_lo, ext{k}, tid, nth);")
    L += ["}", ""]
    L += [
        "// Phase 1 + k evaluates member k over its footprint, the last",
        "// phase writes the sub-tile. Threads tid, tid + nth, ... share",
        "// the work.",
        "HL_FN void phase(const Params& p, int bx, int by, int tid, int nth,",
        "                 unsigned char* smem, int ph) {",
        "  const Tile t = tile_at(p, bx, by, smem);",
        "  switch (ph) {",
    ]
    for k, m in enumerate(plan.members):
        cn = _field(m)
        L.append(f"  case {k + 1}: {{")
        walk_box(L, [e for _k, _d, _o, e in m.dims], [
            f"      point_{cn}(t, i, "
            + ", ".join(f"t.{cn}_lo[{d}] + c{d}" for d in range(len(m.dims)))
            + ");"])
        L += ["    break;", "  }"]
    L.append(f"  case {len(plan.members) + 1}: {{")
    ext, lo = [], []
    for i in range(nd_out):
        if i == plan.xi:
            ext.append(plan.sx)
            lo.append("t.x0")
        elif i == plan.yi:
            ext.append(plan.sy)
            lo.append("t.y0")
        else:
            ext.append(plan.extents[i])
            lo.append(str(plan.mins[i]))
    body = [f"      const int a{d} = {lo[d]} + c{d};" for d in range(nd_out)]
    off = " + ".join(f"(long long)(a{d} - p.out_min[{d}]) * p.out_stride[{d}]"
                     for d in range(nd_out))
    body.append(f"      p.out[{off}] = point_out(t, "
                + ", ".join(f"a{d}" for d in range(nd_out)) + ");")
    walk_box(L, ext, body)
    L += ["    break;", "  }", "  }", "}", ""]
    L += [
        f"constexpr int NPHASE = {len(plan.members) + 2};",
        "",
        "// One block: stages the windows of its sub-tile (bx, by), then runs",
        "// the phases, a barrier between each two. STAGE and COMPUTE are",
        "// both true but in the kernels that time the two apart.",
        "HL_FN void run_block(const Params& p, int bx, int by, int tid,",
        "                     int nth, unsigned char* smem) {",
        "  if (STAGE) {",
        "    stage(p, bx, by, tid, nth, smem);",
        "    hl_async_wait();",
        "    hl_sync();",
        "  }",
        "  for (int ph = 1; COMPUTE && ph < NPHASE; ++ph) {",
        "    if (ph > 1) hl_sync();",
        "    phase(p, bx, by, tid, nth, smem, ph);",
        "  }",
        "}",
        "",
        "}  // namespace",
        "",
    ]

    # the launcher's plain C signature, and ctypes argtypes to match
    sig: List[Tuple[str, str, object]] = []
    for k, w in enumerate(plan.windows):
        sig.append(("const void*", f"in{k}", ctypes.c_void_p))
        for kind, ct in (("stride", ("long long", ctypes.c_longlong)),
                         ("rmin", ("int", ctypes.c_int)),
                         ("rsize", ("int", ctypes.c_int))):
            for j in range(len(w.dims)):
                sig.append((ct[0], f"in{k}_{kind}{j}", ct[1]))
    sig.append(("void*", "out", ctypes.c_void_p))
    for kind, ct in (("stride", ("long long", ctypes.c_longlong)),
                     ("min", ("int", ctypes.c_int)),
                     ("ext", ("int", ctypes.c_int))):
        for j in range(nd_out):
            sig.append((ct[0], f"out_{kind}{j}", ct[1]))
    for name in ("smem_bytes", "grid_x", "grid_y"):
        sig.append(("int", name, ctypes.c_int))
    params = ", ".join(f"{c} {n}" for c, n, _ in sig)
    fill = []
    for k, w in enumerate(plan.windows):
        fill.append(f"  p.in{k}.ptr = in{k};")
        for j in range(len(w.dims)):
            fill.append(f"  p.in{k}.stride[{j}] = in{k}_stride{j}; "
                        f"p.in{k}.rmin[{j}] = in{k}_rmin{j}; "
                        f"p.in{k}.rsize[{j}] = in{k}_rsize{j};")
        fill.append(f"  p.in{k}.unit = hl_copy_unit<{ctype(w.type)}, "
                    f"{len(w.dims)}>(p.in{k});")
    fill.append(f"  p.out = ({ctype(plan.out_type)}*)out;")
    for j in range(nd_out):
        fill.append(f"  p.out_stride[{j}] = out_stride{j}; "
                    f"p.out_min[{j}] = out_min{j}; "
                    f"p.out_ext[{j}] = out_ext{j};")
    L += [
        "#ifdef __CUDACC__",
        "__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) "
        "KERNEL(Params p) {",
        "  extern __shared__ __align__(16) unsigned char smem[];",
        "  run_block(p, blockIdx.x, blockIdx.y, threadIdx.x, blockDim.x,"
        " smem);",
        "}",
        "",
        f'extern "C" int LAUNCH({params}, void* stream) {{',
        "  Params p;",
    ] + fill + [
        "  // all of the SM's unified memory to shared memory, so that the",
        "  // resident blocks the plan counts on fit",
        "  cudaError_t e = cudaFuncSetAttribute(",
        "      KERNEL, cudaFuncAttributePreferredSharedMemoryCarveout,",
        "      cudaSharedmemCarveoutMaxShared);",
        "  if (e != cudaSuccess) return (int)e;",
        "  if (smem_bytes > 48 * 1024) {",
        "    e = cudaFuncSetAttribute(",
        "        KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize,"
        " smem_bytes);",
        "    if (e != cudaSuccess) return (int)e;",
        "  }",
        "  KERNEL<<<dim3(grid_x, grid_y), THREADS, smem_bytes, "
        "(cudaStream_t)stream>>>(p);",
        "  return (int)cudaGetLastError();",
        "}",
        "#else",
        "// Host build of the same blocks, one thread each (CPU tests): the",
        "// same staging paths, with plain copies.",
        f'extern "C" int HOST({params}) {{',
        "  Params p;",
    ] + fill + [
        "  static unsigned char smem[SMEM_MAX > 0 ? SMEM_MAX : 16]"
        " __attribute__((aligned(16)));",
        "  if (smem_bytes > SMEM_MAX) return 1;",
        "  for (int by = 0; by < grid_y; ++by)",
        "    for (int bx = 0; bx < grid_x; ++bx)",
        "      run_block(p, bx, by, 0, 1, smem);",
        "  return 0;",
        "}",
        "#endif",
        "",
    ]
    body = "\n".join(L)
    h = hashlib.sha1(body.encode()).hexdigest()[:16]
    source = body.replace("LAUNCH(", f"launch_{h}(").replace(
        "HOST(", f"host_run_{h}(").replace("KERNEL", f"group_{h}")
    return source, h, [a for _c, _n, a in sig]


# ---------------------------------------------------------------------------
# build and launch
# ---------------------------------------------------------------------------

def build(plan: GroupPlan) -> ctypes.CDLL:
    """nvcc the plan's source into build/kernels/<hash>.so (once per
    source, through ops/build.py) and load it. Raises with nvcc's stderr
    on failure."""
    h = plan.symbol
    cu = _build.BUILD_DIR / f"{h}.cu"
    if not (_build.BUILD_DIR / f"{h}.so").exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu.write_text(plan.source)
    lib = _build.load(h, cu)
    fn = getattr(lib, f"launch_{h}")
    fn.argtypes = list(plan.arg_types) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def launch_args(plan: GroupPlan, inputs, real_mins, out) -> list:
    """The launcher's arguments after the kernel's own constants: pointers,
    strides and realized bounds per pipeline dim, the output region, the
    shared-memory bytes and the grid."""
    args = []
    for w, arr, rmins in zip(plan.windows, inputs, real_mins):
        nd = arr.ndim
        args.append(arr.data_ptr())
        args += [arr.stride(nd - 1 - j) for j in range(nd)]
        args += [int(m) for m in rmins]
        args += [arr.shape[nd - 1 - j] for j in range(nd)]
    n = out.ndim
    args.append(out.data_ptr())
    args += [out.stride(n - 1 - j) for j in range(n)]
    args += list(plan.mins) + list(plan.extents)
    args += [plan.smem_bytes, plan.ncx, plan.ncy]
    return args


def launch(plan: GroupPlan, inputs, real_mins) -> torch.Tensor:
    """Launch the group kernel on CUDA tensors; the output is allocated
    here. Raises on a build, load or launch error."""
    global launches
    with spans.span(spans.K1_LAUNCH, plan.f.name):
        for w, arr in zip(plan.windows, inputs):
            if arr.device.type != "cuda":
                raise ValueError(f"input {w.name} is not on the card")
            if arr.dtype != torch_dtype(w.type):
                raise ValueError(f"input {w.name}: {arr.dtype}, expected "
                                 f"{torch_dtype(w.type)}")
        dev = inputs[0].device if inputs else torch.device("cuda")
        fn = getattr(build(plan), f"launch_{plan.symbol}")
        out = torch.empty(tuple(reversed(plan.extents)),
                          dtype=torch_dtype(plan.out_type), device=dev)
        rc = fn(*launch_args(plan, inputs, real_mins, out),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"group kernel launch_{plan.symbol} failed: "
                               f"cudaError {rc}")
        launches += 1
        return out

"""Schedule representation (reference: src/Schedule.h).

A declarative description of how each stage is lowered, attached to Funcs and
Stages by the directive methods in func.py. What the CUDA lowering makes of
the loop-level concepts:

- split/tile       -> the tile grid of the stencil-group kernel
                      (ops/group_kernel); each CUDA block computes one
                      sub-tile of a schedule tile
- vectorize        -> advisory (threads of a block walk the tile)
- parallel         -> advisory (every block runs in parallel)
- compute_at       -> producer evaluated in shared memory inside the
                      consumer's kernel, over its halo'd footprint
- compute_root     -> materialized whole-array (eval_torch)
- store_at + fold  -> recorded; a store_at producer is computed whole in
                      every sub-tile: the port does not carry it, as the
                      carry measured slower on the H100 (PERF.md)
- async+ring_buffer-> recorded only
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple

from .expr import CompileError, Expr


class ForType(enum.Enum):
    SERIAL = "serial"
    PARALLEL = "parallel"
    VECTORIZED = "vectorized"
    UNROLLED = "unrolled"
    GPU_BLOCK = "gpu_block"     # accepted for ported schedules; maps to grid
    GPU_THREAD = "gpu_thread"   # maps to intra-tile lanes


class TailStrategy(enum.Enum):
    """(reference: src/Schedule.h:35-139). The CUDA group kernel
    (ops/group_kernel) handles every strategy the same way: the last
    tile's origin is shifted inwards, min(o, extent - tile), so it
    recomputes the overlap band instead of reading outside the required
    region (the reference's ShiftInwards). Where the extent is below the
    tile, the tile shrinks to the extent. For the pure single-definition
    consumers the kernel accepts this is value-identical to GuardWithIf
    masking and to RoundUp (no side effects to observe)."""
    Auto = "auto"
    RoundUp = "round_up"
    GuardWithIf = "guard_with_if"
    Predicate = "predicate"
    PredicateLoads = "predicate_loads"
    PredicateStores = "predicate_stores"
    ShiftInwards = "shift_inwards"
    ShiftInwardsAndBlend = "shift_inwards_and_blend"
    RoundUpAndBlend = "round_up_and_blend"


class LoopAlignStrategy(enum.Enum):
    """compute_with iteration-space alignment (reference: src/Schedule.h:
    139-152). In the reference, AlignStart/AlignEnd SHIFT the fused child's
    iteration space so loop mins (or maxes) coincide, and guards keep every
    stage computing exactly its own required box
    (src/ScheduleFunctions.cpp:303-356) -- values are identical across all
    variants; only the pairing of co-executing iterations changes. In this
    array lowering each clique member is evaluated exactly over its own
    box (the guards are implicit in the array model), so all variants are
    value-identical by construction; the strategy is recorded, serialized,
    and surfaced in the stmt report so ported schedules keep their intent."""
    Auto = "auto"
    AlignStart = "align_start"
    AlignEnd = "align_end"
    NoAlign = "no_align"


@dataclasses.dataclass
class Split:
    old: str
    outer: str
    inner: str
    factor: Any            # Expr|int
    kind: str              # 'split' | 'fuse' | 'rename'
    tail: TailStrategy = TailStrategy.Auto


@dataclasses.dataclass
class Dim:
    var: str
    for_type: ForType = ForType.SERIAL
    is_rvar: bool = False


@dataclasses.dataclass
class Bound:
    var: str
    min: Optional[Expr]
    extent: Optional[Expr]
    modulus: Optional[Expr] = None
    remainder: Optional[Expr] = None


class LoopLevel:
    """compute_at/store_at anchor (reference: src/Schedule.h:205-260).
    Late-bound: may be created unset and .set() later; locked at lowering."""

    INLINE = "inline"
    ROOT = "root"

    def __init__(self, func=None, var=None, kind: Optional[str] = None):
        if kind is not None:
            self.kind = kind
            self.func = None
            self.var = None
        elif func is None:
            self.kind = "unset"
            self.func = None
            self.var = None
        else:
            self.kind = "at"
            self.func = func
            self.var = var

    @staticmethod
    def inlined() -> "LoopLevel":
        return LoopLevel(kind=LoopLevel.INLINE)

    @staticmethod
    def root() -> "LoopLevel":
        return LoopLevel(kind=LoopLevel.ROOT)

    def set(self, other: "LoopLevel") -> None:
        self.kind = other.kind
        self.func = other.func
        self.var = other.var

    def is_inlined(self) -> bool:
        return self.kind == LoopLevel.INLINE

    def is_root(self) -> bool:
        return self.kind == LoopLevel.ROOT

    def defined(self) -> bool:
        return self.kind != "unset"

    def __repr__(self):
        if self.kind == "at":
            vn = getattr(self.var, "name", self.var)
            return f"at({self.func.name}, {vn})"
        return self.kind


@dataclasses.dataclass
class StorageDim:
    var: str
    fold_factor: Optional[int] = None
    fold_forward: bool = True


class StageSchedule:
    """Per-definition loop schedule (reference: src/Schedule.h:679)."""

    def __init__(self, loop_vars: List[str], rvar_names: List[str]):
        self.splits: List[Split] = []
        # innermost-first loop order, like the reference's dims list
        self.dims: List[Dim] = [Dim(v) for v in loop_vars] + [
            Dim(r, is_rvar=True) for r in rvar_names]
        self.atomic = False
        self.allow_races = False
        # compute_with records: ((func, def_index), var_name, align) where
        # align maps var_name -> LoopAlignStrategy for the fused loops
        self.fused_with: List[Tuple[Any, str, Dict[str, Any]]] = []
        self.rfactored_from = None

    def find_dim(self, name: str) -> int:
        for i, d in enumerate(self.dims):
            if d.var == name:
                return i
        raise CompileError(
            f"no loop variable named {name!r}; have "
            + ", ".join(d.var for d in self.dims))

    def has_dim(self, name: str) -> bool:
        return any(d.var == name for d in self.dims)

    # specialization variants apply directives for one compile only
    # (reference: src/Func.h:1770-1842 -- each branch of the if-ladder is an
    # independently scheduled copy); snapshot/restore bounds the mutation
    def snapshot(self):
        return (list(self.splits), [dataclasses.replace(d) for d in self.dims],
                self.atomic, self.allow_races, list(self.fused_with),
                self.rfactored_from)

    def restore(self, snap):
        (self.splits, self.dims, self.atomic, self.allow_races,
         self.fused_with, self.rfactored_from) = (
            list(snap[0]), [dataclasses.replace(d) for d in snap[1]],
            snap[2], snap[3], list(snap[4]), snap[5])


class FuncSchedule:
    """Per-func schedule (reference: src/Schedule.h:571)."""

    def __init__(self):
        self.compute_level = LoopLevel()    # unset => default policy
        self.store_level = LoopLevel()
        self.bounds: List[Bound] = []
        self.estimates: List[Bound] = []
        self.storage_dims: List[StorageDim] = []
        self.memoized = False
        self.memoize_eviction_key = None
        self.is_async = False
        self.ring_buffer_extent: Optional[int] = None
        self.trace_loads = False
        self.trace_stores = False
        self.trace_realizations = False
        self.no_profiling = False
        self.tags: List[str] = []
        # debug_to_file(filename): dump the realization when produced
        # (reference: src/DebugToFile.cpp, Lower.cpp:257)
        self.debug_file: Optional[str] = None
        # multi-chip: (var_name, mesh_axis_name) -- consumed by
        # Pipeline.realize(mesh=...) / parallel.distributed_realize
        self.distributed = None

    def snapshot(self):
        cl = LoopLevel(self.compute_level.func, self.compute_level.var,
                       self.compute_level.kind)
        sl = LoopLevel(self.store_level.func, self.store_level.var,
                       self.store_level.kind)
        return (cl, sl, list(self.bounds), list(self.estimates),
                list(self.storage_dims), self.memoized,
                self.memoize_eviction_key, self.is_async,
                self.ring_buffer_extent, list(self.tags))

    def restore(self, snap):
        self.compute_level = LoopLevel(snap[0].func, snap[0].var,
                                       snap[0].kind)
        self.store_level = LoopLevel(snap[1].func, snap[1].var, snap[1].kind)
        (self.bounds, self.estimates, self.storage_dims, self.memoized,
         self.memoize_eviction_key, self.is_async, self.ring_buffer_extent,
         self.tags) = (list(snap[2]), list(snap[3]), list(snap[4]), snap[5],
                       snap[6], snap[7], snap[8], list(snap[9]))

"""The row-histogram kernel (K3): counts[r, k] = #{p : lin[r, p] == k} for
an (R, P) int32 array, as f32 times a constant g; bins outside [0, K) drop.

It replaces `halide_tpu/ops/onehot_mxu.py:103` `rowhist_blockdiag` (its
`pl.pallas_call` at `:200`) for Hopper (sm_90a). The CUDA source is
`csrc/rowhist_kernel.cu`, built through ops/build.py (nvcc -> plain-C `.so`
-> ctypes).

- Bound: device-memory bytes (lin read once, the (R, K) counts written).
- Design: counters in shared memory (the TPU body's one-hot MXU products
  are not carried over). A plan (`plan_rowhist`, recorded in `last_plan`)
  sets rows a block and threads so that the grid fills the card, the load
  unit (16, 8 or 4 bytes: the widest the strides allow) and loads in flight
  a lane (evict-first, the first of them issued before the block zeroes its
  counters), `copies` of each row's counters (one per warp or group of
  warps), and where rows are too few to fill the card a thread-block
  cluster that splits each row (merged through distributed shared memory).
  The rule's constants were fitted on a sweep on the card
  (`tools/k3_sweep.py`). Integer atomics commute, so the result is exact
  and deterministic.

Beside the kernel: `rowhist_plain`, its plain PyTorch version (an integer
`scatter_add_` of ones into (R, K + 1), the drop column last, cut off).
`rowhist` takes it only for tensors that lie on the CPU; on a CUDA tensor it
launches the kernel or raises. `launch(..., plan={...})` forces plan fields
(the rest from the rule); a plan the kernel cannot take raises before the
launch. `launches` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from . import build as _build

launches = 0                              # kernel launches on CUDA tensors
last_plan: Optional[dict] = None          # the plan of the latest launch

_SMEM_LIMIT = 227 * 1024       # shared memory one block can take
_SMEM_SM = 228 * 1024          # an SM's shared memory, 1 KB of it per block
_SMS = 132                     # H100 SXM
_MAX_K = _SMEM_LIMIT // 4      # one row's K int32 counters, one copy
_MAX_CLUSTER = 8               # the portable cluster size
PLAN_FIELDS = ("rows", "threads", "unit", "inflight", "copies", "cluster")
UNITS = (4, 8, 16)             # load unit, bytes
# loads a lane issues before it counts, as the source takes them; a build
# holds the kernels of the rule's and the first design's points
# (`rowhist_has`; csrc/rowhist_kernel.cu's ROWHIST_KERNELS)
INFLIGHT = (1, 2, 4, 8)

# the first design's geometry as a plan point of this build: 8 rows, 256
# threads, 4-byte loads, one copy, no cluster; 8 loads in flight, at which
# this build took the first design's own time on the card
# (tools/k3_sweep.py --parent-source)
OLD_DESIGN = dict(rows=8, threads=256, unit=4, inflight=8, copies=1,
                  cluster=1)

# The rule's constants, fitted on the card (tools/k3_sweep.py --fit: the
# grid of constants whose plans lose least against each swept input's
# fastest point)
_RULE = dict(values=8,         # int32 values in flight a lane: loads in
                               # flight times the unit's values
             rounds=2,         # rounds of those loads a lane takes
             rf_rows=32,       # rows a block with rows_fast
             waves=0.5,        # split rows over a cluster below this many
                               # waves of resident blocks
             copies=1)         # counter copies a row (at most its warps)


def rowhist_plain(lin2d: torch.Tensor, K: int,
                  scale: float = 1.0) -> torch.Tensor:
    """(R, P) int bins -> (R, K) f32 counts * scale; bins outside [0, K)
    drop."""
    lin = lin2d.to(torch.int64)
    lin = torch.where((lin < 0) | (lin >= K), K, lin)
    counts = torch.zeros((lin.shape[0], K + 1), dtype=torch.int32,
                         device=lin.device)
    counts.scatter_add_(1, lin, torch.ones_like(lin, dtype=torch.int32))
    return counts[:, :K].to(torch.float32) * scale


def rowhist(lin2d: torch.Tensor, K: int, scale: float = 1.0) -> torch.Tensor:
    """Row histograms of `lin2d` as f32 counts * scale: on the CPU through
    the plain version, on the card through the kernel."""
    if lin2d.device.type == "cpu":
        return rowhist_plain(lin2d, K, scale)
    return launch(lin2d, K, scale)


def layout(lin2d: torch.Tensor):
    """-> (rows_fast, the widest load unit in bytes, the base address
    modulo 16): rows_fast where neighbouring rows are adjacent in memory (an
    item is one pixel of unit / 4 rows; the unit divides the pixel stride
    and the base address); else a row's items are unit / 4 neighbouring
    bins (the unit divides the row stride, and the `head` elements before
    the first aligned unit, the same in every row, are counted one by
    one); 4 bytes where neither stride is 1."""
    R, P = lin2d.shape
    srow, sp = lin2d.stride()
    phase = lin2d.data_ptr() % 16
    rows_fast = srow == 1 and sp != 1 and R > 1
    if rows_fast:
        unit = next(u for u in (16, 8, 4) if (sp * 4) % u == 0
                    and phase % u == 0)
    elif sp != 1 and P > 1:
        unit = 4
    else:
        unit = next(u for u in (16, 8, 4) if R == 1 or (srow * 4) % u == 0)
    return rows_fast, unit, phase


def head(lin_layout, unit: int) -> int:
    """Row layout: elements of each row before its first `unit`-aligned
    address."""
    rows_fast, _unit, phase = lin_layout
    return 0 if rows_fast else (-phase % unit) // 4


def resident_model(threads: int, smem: int, values: int = 1) -> int:
    """Blocks an SM holds at the card's limits (2048 threads, 32 blocks,
    228 KB of shared memory with 1 KB a block), with the kernel's register
    budget: 32 a thread up to 8 values loaded in flight, else 64 (1024
    threads). On the card, CUDA's occupancy calculator counts instead
    (`resident_of`)."""
    per_sm = 2048 if values <= 8 else 1024
    return min(32, per_sm // threads, _SMEM_SM // (smem + 1024))


def _items(P, lin_layout, unit):
    """Items of a row: pixels with rows_fast, else whole units."""
    if lin_layout[0]:
        return P
    return (P - min(head(lin_layout, unit), P)) // (unit // 4)


def plan_rowhist(R: int, P: int, K: int, lin_layout, force=None,
                 resident: Optional[Callable] = None) -> dict:
    """The plan of one launch: the rule's fields, with those in `force`
    put in their place, checked (`check_plan`), and what follows from them
    (shared bytes, grid, resident blocks an SM, waves). `lin_layout` is
    `layout(lin)`; `resident(plan)` gives blocks an SM (by default
    `resident_model`)."""
    rows_fast, max_unit, _phase = lin_layout
    force = dict(force or {})
    rule = dict(_RULE)
    # rows whose counters fit the block's shared memory, one copy each
    rows_cap = 1 << max(_SMEM_LIMIT // (4 * max(K, 1)), 1).bit_length() - 1
    unit = force.get("unit", max_unit)
    if not rows_fast:
        rows = force.get("rows", 1)
    else:
        rows = force.get("rows", min(max(rule["rf_rows"], unit // 4),
                                     rows_cap))
        unit = force.get("unit", min(unit, 4 * rows))
    # loads in flight: the rule's values in flight a lane at this unit
    L = force.get("inflight", max(1, min(
        INFLIGHT[-1], rule["values"] // (unit // 4))))
    if not rows_fast:
        # a row's team: whole warps, each lane `rounds` rounds of L loads
        items = _items(P, lin_layout, unit)
        team = min(1024, 32 * max(1, -(-items // (32 * L * rule["rounds"]))))
        threads = force.get("threads", team * rows)
        warps_row = max(threads // rows // 32, 1)
        lanes = threads // rows
    else:
        items, w = P, unit // 4
        g = max(rows // w, 1)              # lanes across a pixel's rows
        need = -(-items // (L * rule["rounds"]))     # lanes along pixels
        threads = force.get("threads", min(1024, max(
            32, 32 * -(-need * g // 32))))
        warps_row = max(threads // 32, 1)
        lanes = threads // g
    copies = force.get("copies", max(1, min(
        rule["copies"], warps_row, _SMEM_LIMIT // (4 * rows * max(K, 1)))))
    plan = dict(layout="rows_fast" if rows_fast else "rows", rows=rows,
                threads=threads, unit=unit, inflight=L, copies=copies,
                cluster=1)
    res = resident or (lambda p: resident_model(
        p["threads"], p["smem_bytes"], p["unit"] // 4 * p["inflight"]))
    check_plan(plan, R, P, K, lin_layout)
    plan["smem_bytes"] = 4 * rows * copies * K
    if "cluster" in force:
        plan["cluster"] = force["cluster"]
    else:
        # fewer row groups than `waves` waves of resident blocks: split
        # each row over a cluster, while each block keeps at least a round
        # of loads a lane
        slots = _SMS * max(res(plan), 1)
        groups = -(-R // rows)
        while (plan["cluster"] < _MAX_CLUSTER
               and 2 * groups * plan["cluster"] <= rule["waves"] * slots
               and items // (2 * plan["cluster"]) >= lanes * L):
            plan["cluster"] *= 2
    check_plan(plan, R, P, K, lin_layout)
    plan["grid"] = -(-R // plan["rows"]) * plan["cluster"]
    plan["resident"] = res(plan)
    plan["waves"] = plan["grid"] / (_SMS * max(plan["resident"], 1))
    return plan


def check_plan(plan: dict, R: int, P: int, K: int, lin_layout) -> None:
    """Raise ValueError for a plan the kernel cannot take."""
    rows_fast, max_unit, _phase = lin_layout
    rows, nt, unit = plan["rows"], plan["threads"], plan["unit"]
    copies, cl = plan["copies"], plan["cluster"]

    def bad(msg):
        raise ValueError(f"row-histogram kernel: plan {plan}: {msg}")
    if not 0 < K <= _MAX_K:
        bad(f"K={K} outside (0, {_MAX_K}]")
    if unit not in UNITS or unit > max_unit:
        bad(f"load unit {unit} not in {UNITS} or wider than the {max_unit} "
            "bytes the strides and base allow")
    if plan["inflight"] not in INFLIGHT:
        bad(f"loads in flight not in {INFLIGHT}")
    if not (32 <= nt <= 1024 and nt % 32 == 0):
        bad("threads must be a multiple of 32 in [32, 1024]")
    if rows < 1 or rows & (rows - 1):
        bad("rows a block must be a power of two")
    if not rows_fast and nt % (32 * rows):
        bad("a row's team of threads must be whole warps")
    if rows_fast and (rows % (unit // 4) or rows // (unit // 4) > 32):
        bad("rows_fast: rows a block must be a multiple of the unit's rows, "
            "at most 32 lanes across them")
    warps_row = nt // 32 if rows_fast else nt // rows // 32
    if not 1 <= copies <= warps_row:
        bad(f"copies must be in [1, {warps_row}] (warps counting a row)")
    if 4 * rows * copies * K > _SMEM_LIMIT:
        bad(f"{4 * rows * copies * K} bytes of counters over the "
            f"{_SMEM_LIMIT} a block can take")
    if not 1 <= cl <= _MAX_CLUSTER:
        bad(f"cluster size outside [1, {_MAX_CLUSTER}]")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points of a build of csrc/rowhist_kernel.cu."""
    i, ll, vp = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.rowhist.argtypes = [vp, ll, ll, i, i, i, ctypes.c_float, vp, i, i,
                            i, i, i, i, i, i, vp]
    lib.rowhist.restype = i
    lib.rowhist_has.argtypes = [i, i]
    lib.rowhist_has.restype = i
    lib.rowhist_resident.argtypes = [i, i, i, i]
    lib.rowhist_resident.restype = i
    return lib


_RESIDENT: dict = {}     # (build, unit, inflight, threads, smem) -> n


def resident_of(lib: ctypes.CDLL) -> Callable:
    """plan -> blocks an SM holds, from the build (CUDA's occupancy
    calculator on the card), asked once per kernel, threads and shared
    bytes; raises ValueError where the build holds no kernel of the plan's
    unit and loads in flight, RuntimeError if it cannot tell."""
    def res(plan):
        key = (id(lib), plan["unit"], plan["inflight"], plan["threads"],
               plan["smem_bytes"])
        n = _RESIDENT.get(key)
        if n is None:
            if not lib.rowhist_has(plan["unit"], plan["inflight"]):
                raise ValueError(
                    f"row-histogram kernel: plan {plan}: this build holds "
                    f"no kernel of a {plan['unit']}-byte unit with "
                    f"{plan['inflight']} loads in flight")
            n = lib.rowhist_resident(plan["unit"], plan["inflight"],
                                     plan["threads"], plan["smem_bytes"])
            if n < 0:
                raise RuntimeError(f"row-histogram kernel: occupancy of "
                                   f"{plan} unknown (cudaError {-n})")
            _RESIDENT[key] = n
        return n
    return res


def call(lib: ctypes.CDLL, lin2d: torch.Tensor, K: int, scale: float,
         out: torch.Tensor, stream=None, plan=None) -> int:
    """Call the entry point of `lib` for an (R, P) int32 lin (any strides)
    into the contiguous (R, K) f32 `out`, at the rule's plan with the
    `PLAN_FIELDS` that `plan` holds forced (a whole plan forces them all).
    Returns the entry point's code
    (cudaGetLastError() on the card)."""
    global last_plan
    R, P = lin2d.shape
    srow, sp = lin2d.stride()
    lay = layout(lin2d)
    plan = plan_rowhist(R, P, K, lay, plan and {
        k: plan[k] for k in PLAN_FIELDS if k in plan}, resident_of(lib))
    last_plan = plan
    return lib.rowhist(lin2d.data_ptr(), srow, sp, R, P, K, float(scale),
                       out.data_ptr(), int(lay[0]), head(lay, plan["unit"]),
                       plan["rows"], plan["threads"], plan["unit"],
                       plan["inflight"], plan["copies"], plan["cluster"],
                       stream)


def launch(lin2d: torch.Tensor, K: int, scale: float = 1.0,
           plan=None) -> torch.Tensor:
    """Launch K3 on a CUDA int32 (R, P) tensor (any strides); the (R, K)
    f32 output is allocated here. `plan`: the `PLAN_FIELDS` to force on
    the rule's plan, or a whole plan from `last_plan` or `plan_rowhist`.
    Raises on a tensor or a plan it does not take and on a build or launch
    error."""
    global launches
    if lin2d.device.type != "cuda":
        raise ValueError("row-histogram kernel: lin is not on the card")
    if lin2d.dtype != torch.int32 or lin2d.dim() != 2:
        raise ValueError(f"row-histogram kernel: lin must be a 2-D int32 "
                         f"tensor, got {lin2d.dtype} {tuple(lin2d.shape)}")
    if not 0 < K <= _MAX_K:
        raise ValueError(f"row-histogram kernel: K={K} outside (0, {_MAX_K}]")
    out = torch.empty((lin2d.shape[0], K), dtype=torch.float32,
                      device=lin2d.device)
    rc = call(bind(_build.load_fixed("rowhist_kernel")), lin2d, K, scale, out,
              torch.cuda.current_stream(lin2d.device).cuda_stream, plan)
    if rc != 0:
        raise RuntimeError(f"row-histogram kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out

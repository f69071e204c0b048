"""Autoschedulers (reference: src/autoschedulers/, plugins registered via
Pipeline::add_autoscheduler @ Pipeline.cpp:280), the counterpart of the JAX
package's autoschedule.py.

Two schedulers over one analytical cost model:

- "Mullapudi2016": greedy hill-climb over materialization choices (the
  grouping decision of the reference's mullapudi2016) plus output tiling
  for the stencil-group kernel K1.
- "Adams2019": beam search over the same decision space with the same cost
  model (the reference pairs its beam search with a learned cost model,
  DefaultCostModel.cpp:396; this one is analytical).

The cost model scores a set of materialization decisions with three terms,
whose coefficients are measured on the card (target.FITTED_COST, by
tools/fitcost.py):
  * bytes moved: every materialized func pays write + read-per-consumer
    of its inferred footprint (bounds pass over the output estimates);
  * recompute: inlined funcs pay their expression ops times the total
    inline multiplicity at each consumer's grid, over `ops_per_byte`;
  * dual-strided fusion penalty: a fused pass whose reads are strided
    (|coeff| >= 2) on two or more axes is charged `strided_penalty` times
    its bytes.
The analysis and the search are the JAX package's, unchanged: the same
coefficients give the same materialization decisions in both packages.
What the schedule does on this card is in `_pick_tile` and `_apply`.

"Li2018" (the gradient autoscheduler) is the reference's search-free
template for autodiff pipelines (li2018/GradientAutoscheduler.cpp):
compute_root + parallelize/vectorize per func, and rfactor'd reduction
parallelism for small-pure-domain associative updates.

"Anderson2021" is the autotuning scheduler: the beam's top-K candidates
are applied to serialized clones, realized and timed (CUDA events after a
warm-up on the card, the wall clock on the CPU), and the measured winner
is applied -- the reference's autotune_loop + retrain cycle collapsed to
one in-process tournament.
"""
from __future__ import annotations

import math
import sys
from typing import Dict, List, Set, Tuple

from . import expr as E
from .bounds import BoundsEngine, Box, Interval
from .expr import CompileError
from .visitors import walk

_REGISTRY = {}

# the cost-model coefficients of the host card, read once a process
# (target.fitted_cost_params; `_FITTED = None` reads them again)
_FITTED = None


def _cost_params() -> dict:
    global _FITTED
    if _FITTED is None:
        from .target import fitted_cost_params
        _FITTED = fitted_cost_params()
    return _FITTED


def _itemsize(t) -> int:
    return max(1, t.bits // 8)


def register_autoscheduler(name: str, fn):
    _REGISTRY[name] = fn


def apply_autoscheduler(pipeline, target=None, params=None):
    params = params or {}
    name = params.get("name", "Mullapudi2016")
    if name not in _REGISTRY:
        raise CompileError(
            f"unknown autoscheduler {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](pipeline, target, params)


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

class _Analysis:
    """Static facts the cost model consumes: per-func footprints (from the
    output estimates), expression op counts, and per-edge read structure
    (#call sites, max |stride| per axis pair)."""

    def __init__(self, pipeline):
        from .pipeline import _BoundsPass, gather_graph
        self.g = gather_graph(pipeline.outputs)
        self.funcs = self.g.funcs
        self.by_id = {id(f): f for f in self.funcs}
        est_regions = {}
        for out in pipeline.outputs:
            ext = _estimate_extents(out)
            if ext is None:
                raise CompileError(
                    f"autoscheduler: output {out.name} needs "
                    "set_estimates() on every dimension")
            est_regions[id(out)] = Box(
                [Interval(0, e - 1) for e in ext])
        engine = BoundsEngine(resolver=lambda n, a: None)
        bp = _BoundsPass(self.g, engine)
        try:
            bp.run(pipeline.outputs, est_regions)
        except CompileError:
            bp = None
        # inferred whole-image boxes (stencil halos are size-independent,
        # so producer_extent - output_extent is also the per-tile halo):
        # the tile-shape search reads these
        self.boxes = bp.boxes if bp is not None else {}
        self.points: Dict[int, float] = {}
        self.bytes: Dict[int, float] = {}
        for f in self.funcs:
            pts = None
            if bp is not None:
                b = bp.boxes.get(id(f))
                if b is not None and b.defined() and b.bounded():
                    pts = 1.0
                    for e in b.extents():
                        pts *= max(1, int(e))
            if pts is None:
                pts = 1.0
                for e in est_regions[next(iter(est_regions))].extents():
                    pts *= max(1, int(e))
            itemsize = _itemsize(f._defs[0].values[0].dtype) \
                if f._defs else 4
            self.points[id(f)] = pts
            self.bytes[id(f)] = pts * itemsize * len(f._defs[0].values)
        # per-func expression op count
        self.ops: Dict[int, float] = {}
        for f in self.funcs:
            n = 0
            for d in f._defs:
                for v in list(d.values) + list(d.predicates):
                    c = [0]
                    walk(v, lambda _n: c.__setitem__(0, c[0] + 1))
                    n += c[0]
            self.ops[id(f)] = float(max(1, n))
        # edges: consumer id -> {producer id: (n_reads, per-axis max|coeff|)}
        self.reads: Dict[int, Dict[int, Tuple[int, List[int]]]] = {}
        for f in self.funcs:
            acc: Dict[int, Tuple[int, List[int]]] = {}

            def on(nn):
                # record Func AND raw-input reads (strided input reads feed
                # the dual-strided penalty, e.g. a 2x downsample of an
                # ImageParam)
                if isinstance(nn, E.Call) and nn.target is not f \
                        and nn.args:
                    pid = id(nn.target)
                    cnt, coeffs = acc.get(pid, (0, []))
                    cs = [abs(_coeff_of(a)) for a in nn.args]
                    if len(cs) > len(coeffs):
                        coeffs = coeffs + [1] * (len(cs) - len(coeffs))
                    coeffs = [max(o, c2) for o, c2 in zip(coeffs, cs)] \
                        + coeffs[len(cs):]
                    acc[pid] = (cnt + 1, coeffs)

            for d in f._defs:
                for v in list(d.values) + list(d.predicates) + [
                        a for a in d.args if isinstance(a, E.Expr)]:
                    walk(v, on)
            self.reads[id(f)] = acc
        # funcs whose materialization is forced (updates, tuples, extern,
        # memoized, user compute_root/at, specializations, compute_with)
        self.forced: Set[int] = set()
        self.free: List[int] = []
        for f in self.funcs:
            if id(f) in self.g.materialized or f in pipeline.outputs:
                if _is_free_choice(f, pipeline):
                    self.free.append(id(f))
                else:
                    self.forced.add(id(f))
            else:
                if _is_free_choice(f, pipeline):
                    self.free.append(id(f))

    def consumers_of(self, pid) -> List[int]:
        return [cid for cid, rr in self.reads.items() if pid in rr]


def _is_free_choice(f, pipeline) -> bool:
    if f in pipeline.outputs or f.is_extern():
        return False
    if len(f._defs) != 1 or len(f._defs[0].values) != 1:
        return False
    if f._fschedule.compute_level.defined():
        return False          # user decided
    if f._fschedule.memoized or getattr(f, "_specializations", None):
        return False
    if any(d.schedule.fused_with for d in f._defs):
        return False
    return True


def _is_stageable(f, pipeline) -> bool:
    """Eligible to be staged compute_at into a consumer's group (K1).
    Wider than _is_free_choice: update-definition producers qualify (K1
    computes a member's updates in the kernel); the inline/root search
    still never flips them."""
    if f in pipeline.outputs or f.is_extern():
        return False
    if any(len(d.values) != 1 for d in f._defs):
        return False
    if f._fschedule.compute_level.defined():
        return False
    if f._fschedule.memoized or getattr(f, "_specializations", None):
        return False
    if any(d.schedule.fused_with for d in f._defs):
        return False
    return True


def _coeff_of(e) -> int:
    """|stride| of a call arg in its Vars (looks through clamp/min/max/
    casts); 1 for plain/unknown."""
    if isinstance(e, E.Variable):
        return 1
    if isinstance(e, (E.IntImm, E.FloatImm)):
        return 0
    if isinstance(e, E.Binary) and e.op == "mul":
        if isinstance(e.a, E.Variable) and isinstance(e.b, E.IntImm):
            return abs(e.b.value)
        if isinstance(e.b, E.Variable) and isinstance(e.a, E.IntImm):
            return abs(e.a.value)
    kids = [c for c in e.children() if isinstance(c, E.Expr)]
    if kids:
        return max((_coeff_of(c) for c in kids), default=1)
    return 1


def _reads_divided(consumer, producer) -> bool:
    """consumer reads producer at an index divided by a constant (x / 2):
    the pyramid's and the demosaic's half-resolution reads."""
    hit = [False]

    def divided(e):
        return isinstance(e, E.Binary) and e.op == "div" and \
            isinstance(e.b, E.IntImm) and abs(e.b.value) > 1

    def on(n):
        if isinstance(n, E.Call) and n.target is producer:
            for a in n.args:
                walk(a, lambda m: hit.__setitem__(0, hit[0] or divided(m)))
    for d in consumer._defs:
        for v in list(d.values) + list(d.predicates):
            walk(v, on)
    return hit[0]


def _estimate_extents(f):
    est = {b.var: b for b in f._fschedule.estimates}
    out = []
    for v in f._args:
        b = est.get(v.name)
        if b is None or b.extent is None:
            return None
        if isinstance(b.extent, E.IntImm):
            out.append(b.extent.value)
        elif isinstance(b.extent, int):
            out.append(b.extent)
        else:
            return None
    return out


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

def _cost(an: _Analysis, mat: Set[int]) -> float:
    """Byte-equivalent cost of a materialization decision set."""
    cp = _cost_params()
    ops_per_byte = cp["ops_per_byte"]
    strided_penalty = cp["strided_penalty"]
    # inline multiplicity: how many times each inlined func's expression is
    # instantiated (per consumer point), following inlined consumers up
    mult: Dict[int, float] = {}

    def m_of(fid) -> float:
        if fid in mult:
            return mult[fid]
        mult[fid] = 1.0     # cycle guard
        total = 0.0
        for cid in an.consumers_of(fid):
            n_reads, _ = an.reads[cid][fid]
            total += n_reads * (1.0 if cid in mat else m_of(cid))
        mult[fid] = max(1.0, total)
        return mult[fid]

    cost = 0.0
    for fid in an.points:
        if fid in mat:
            n_cons = len(an.consumers_of(fid))
            cost += an.bytes[fid] * (1 + max(1, n_cons))
        else:
            # recompute at each consumer point, scaled by multiplicity
            pts = max(an.points[cid] for cid in an.consumers_of(fid)) \
                if an.consumers_of(fid) else an.points[fid]
            cost += an.ops[fid] * m_of(fid) * pts / ops_per_byte
    # dual-strided fused passes: find materialized consumers whose
    # transitive inlined read cone hits a materialized producer with
    # stride >= 2 on >= 2 axes along the path
    for cid in an.points:
        if cid not in mat:
            continue
        # accumulate per-axis stride products through inlined middles
        hit = [False]
        visited = set()

        def visit(fid, strides):
            if fid in visited:
                return
            visited.add(fid)
            for pid, (_n, coeffs) in an.reads.get(fid, {}).items():
                cs = [s * c2 for s, c2 in
                      zip(strides + [1] * len(coeffs), coeffs)]
                if pid in mat or pid in an.forced or pid not in an.by_id:
                    if sum(1 for c2 in cs if c2 >= 2) >= 2:
                        hit[0] = True
                else:
                    visit(pid, cs)

        visit(cid, [])
        if hit[0]:
            cost += an.bytes[cid] * strided_penalty
    return cost


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def _default_decisions(an: _Analysis) -> Set[int]:
    """The lowering's default policy: free funcs inline, forced stay."""
    return set(an.forced)


def _greedy(an: _Analysis) -> Set[int]:
    mat = _default_decisions(an)
    free = list(an.free)
    cur = _cost(an, mat)
    improved = True
    while improved:
        improved = False
        best = None
        for fid in free:
            cand = set(mat)
            if fid in cand:
                cand.discard(fid)
            else:
                cand.add(fid)
            c = _cost(an, cand)
            if c < cur - 1e-6 and (best is None or c < best[0]):
                best = (c, fid)
        if best is not None:
            cur = best[0]
            mat ^= {best[1]}
            improved = True
    return mat


def _beam(an: _Analysis, width: int = 8) -> Set[int]:
    """Beam search over flip sequences (reference: adams2019's State/
    LoopNest beam, AutoSchedule.cpp; the analytical model instead of a
    learned one)."""
    return _beam_topk(an, width, 1)[0]


def _beam_topk(an: _Analysis, width: int, k: int) -> List[Set[int]]:
    """The beam search, returning the k cheapest DISTINCT states it
    evaluated (candidate pool for the Anderson2021 autotuning pass)."""
    start = frozenset(_default_decisions(an))
    seen = {start: _cost(an, set(start))}
    beam = [(seen[start], start)]
    best = beam[0]
    for _ in range(len(an.free)):
        nxt = {}
        for c0, state in beam:
            for fid in an.free:
                s2 = frozenset(state ^ {fid})
                if s2 in seen or s2 in nxt:
                    continue
                nxt[s2] = _cost(an, set(s2))
        if not nxt:
            break
        seen.update(nxt)
        beam = sorted(((c, s) for s, c in nxt.items()))[:width]
        if beam[0][0] < best[0] - 1e-6:
            best = beam[0]
        else:
            break
    ranked = sorted(seen.items(), key=lambda it: it[1])
    out = [set(s) for s, _c in ranked[:k]]
    return out or [set(start)]


# ---------------------------------------------------------------------------
# tile-shape search
# ---------------------------------------------------------------------------

# K1's largest sub-tile (ops/group_kernel.py): the tile of a schedule bounds
# the sub-tile K1 plans inside it (sx <= tx, sy <= ty)
_K1_SUB = (256, 128)


def _pick_tile(W, H):
    """K1's largest sub-tile, clipped to the extent W x H. -> (tx, ty).

    The JAX model's terms, for this card:
    * halo overcompute, the shared-memory budget and SM fill: K1's planner
      weighs each of them itself for every sub-tile inside the tile (the
      halo's recompute, the 227 KB a block may take, the grid's wave
      quantization over the 132 SMs; its rule was fitted on the card,
      PERF.md section 3), so the tile that leaves it every choice is its
      largest sub-tile;
    * short staged rows (the JAX model's DMA-row term): tilesearch on the
      card did not separate 256x128, 128x64 and 2560x128 on blur beyond the
      spread of one schedule (PERF.md section 6), so no term is modelled until
      a measurement shows one;
    * a band walk, which a tile spanning the width makes, earns nothing:
      K1 plans it one sub-tile a block, as any other launch (it computes a
      store_at member whole in every sub-tile, as the carry measured slower
      on the H100: PERF.md section 6)."""
    return min(_K1_SUB[0], W), min(_K1_SUB[1], H)


# ---------------------------------------------------------------------------
# schedule emission
# ---------------------------------------------------------------------------

def _apply(pipeline, an: _Analysis, mat: Set[int], params) -> dict:
    from .func import Var

    src: List[str] = []
    staged: Set[int] = set()

    # output tiling + staging of small-halo private producers into the
    # output's group (K1 keeps a member in shared memory, so staging wins
    # over both choices the root/inline search weighed)
    for out in pipeline.outputs:
        if len(out._defs) != 1 or len(out._defs[0].values) != 1:
            continue
        if out._defs[0].schedule.splits:
            continue
        ext = _estimate_extents(out)
        n = out.dimensions()
        if n < 2:
            continue
        x, y = out._args[0], out._args[1]
        # candidate members: the transitive closure -- a free func whose
        # every consumer is already in the group joins it (harris: resp and
        # the six gradient-product stages become members of one launch).
        # Unit-stride reads only; K1's planner still has the last word and
        # rejects a group it cannot take (it then runs whole-array). The
        # expression-node cap is the JAX package's, so that both packages
        # stage the same members.
        group = {id(out)}
        cand = []
        node_sum = an.ops[id(out)]
        changed = True
        while changed:
            changed = False
            for p in an.funcs:
                pid = id(p)
                if pid in group or not _is_stageable(p, pipeline):
                    continue
                cons = an.consumers_of(pid)
                if not cons or not all(c in group for c in cons):
                    continue
                names = {v.name for v in p._args}
                if x.name not in names or y.name not in names:
                    continue
                if any(any(c2 > 1 for c2 in an.reads[c][pid][1])
                       for c in cons):
                    continue
                # K1 takes a window read at x / d, not a member: a producer
                # read through a division stays out of the group
                if any(_reads_divided(an.by_id[c], p) for c in cons):
                    continue
                if node_sum + an.ops[pid] > 1800:
                    continue
                node_sum += an.ops[pid]
                group.add(pid)
                cand.append(p)
                changed = True
        if not cand:
            continue
        forced = (params or {}).get("tile")
        if forced is not None:
            # measured tile search (tools/tilesearch.py): the caller times
            # a menu of shapes on the card and forces the winner
            tx, ty = int(forced[0]), int(forced[1])
        else:
            tx, ty = _pick_tile(int(ext[0]), int(ext[1]))
        xo, yo, xi, yi = (Var(f"{v}_as") for v in ("xo", "yo", "xi", "yi"))
        out.tile(x, y, xo, yo, xi, yi, tx, ty)
        out.vectorize(xi)
        out.parallel(yo)
        src.append(f"{out.name}.tile({x.name}, {y.name}, xo, yo, xi, yi, "
                   f"{tx}, {ty}).vectorize(xi).parallel(yo)")
        for p in cand:
            # compute_at alone (the JAX package also writes store_root,
            # asking its planner to carry the member along the grid; K1
            # computes a store_at member whole in every sub-tile, as the
            # carry measured slower on the H100: PERF.md section 6)
            p.compute_at(out, xo)
            staged.add(id(p))
            src.append(f"{p.name}.compute_at({out.name}, xo)")

    for fid in sorted((mat & set(an.free)) - staged,
                      key=lambda i: an.bytes[i]):
        f = an.by_id[fid]
        f.compute_root()
        src.append(f"{f.name}.compute_root()")

    # update-heavy funcs stay at root
    for f in an.funcs:
        if len(f._defs) > 1 and not f._fschedule.compute_level.defined():
            f.compute_root()
            src.append(f"{f.name}.compute_root()")
    return {"schedule_source": ";\n".join(src),
            "cost": _cost(an, mat)}


def _mullapudi(pipeline, target, params):
    an = _Analysis(pipeline)
    mat = _greedy(an)
    return _apply(pipeline, an, mat, params)


def _adams(pipeline, target, params):
    an = _Analysis(pipeline)
    mat = _beam(an, width=int((params or {}).get("beam_size", 8)))
    return _apply(pipeline, an, mat, params)


def _anderson2021(pipeline, target, params):
    """Autotuning autoscheduler (reference: src/autoschedulers/anderson2021
    -- adams2019's beam adapted for throughput hardware, driven by measured
    samples via autotune_loop.sh + retrain). The beam's top-K candidate
    groupings (`samples`) are applied to serialized clones of the pipeline,
    realized with the caller's bound inputs on `params["device"]` (None:
    the card), and timed: CUDA events around `benchmarks` realizes after a
    warm-up on the card, the wall clock on the CPU, the best of three. The
    measured winner is applied to the pipeline. The report's `autotuned`
    keeps `samples`, `times_ms` and `best_ms`."""
    from .buffer import ImageParam
    from .pipeline import _time_ms, resolve_device
    from .serialize import deserialize_pipeline, serialize_pipeline

    params = params or {}
    an = _Analysis(pipeline)
    k = max(1, int(params.get("samples", 4)))
    width = int(params.get("beam_size", 8))
    reps = max(1, int(params.get("benchmarks", 3)))
    cands = _beam_topk(an, width, k)
    if len(cands) <= 1:
        return _apply(pipeline, an, cands[0], params)

    sizes = []
    for out in pipeline.outputs:
        ext = _estimate_extents(out)
        if ext is None:
            sizes = None
            break
        sizes.append(ext)
    in_bufs = {}
    in_scalars = {}
    measurable = sizes is not None and len(pipeline.outputs) == 1
    if measurable:
        for t in an.g.inputs.values():
            if isinstance(t, ImageParam):
                if t._bound is None:
                    measurable = False
                    break
                in_bufs[t.name] = t.get()
        for p in an.g.params.values():
            if p._value is None:
                measurable = False
                break
            in_scalars[p.name] = p.get()
    if not measurable:
        # nothing to time against (unbound inputs / no output estimates):
        # the model-ranked best, as Adams2019
        return _apply(pipeline, an, cands[0], params)
    dev = resolve_device(params.get("device"))

    try:
        blob = serialize_pipeline(pipeline)
    except CompileError:
        return _apply(pipeline, an, cands[0], params)

    def measure(cand: Set[int]) -> float:
        names = {an.by_id[fid].name for fid in cand}
        pipe2, images2, params2 = deserialize_pipeline(blob)
        an2 = _Analysis(pipe2)
        mat2 = {fid for fid in an2.by_id
                if an2.by_id[fid].name in names}
        _apply(pipe2, an2, mat2, params)
        for nm, buf in in_bufs.items():
            images2[nm].set(buf)
        for nm, v in in_scalars.items():
            params2[nm].set(v)

        def run():
            for _ in range(reps):
                pipe2.realize(sizes[0], device=dev)
        pipe2.realize(sizes[0], device=dev)      # plan, build, warm up
        return min(_time_ms(run, dev) for _ in range(3)) / reps

    timed = []
    dropped = []
    for cand in cands:
        try:
            timed.append((measure(cand), cand))
        except CompileError as ex:
            # a candidate the lowering refuses drops out of the tournament
            # -- loudly, so that a fault cannot shrink the sample silently
            names = sorted(an.by_id[fid].name for fid in cand)
            dropped.append({"candidate": names,
                            "err": f"{type(ex).__name__}: {str(ex)[:120]}"})
            print(f"anderson2021: dropped candidate {names}: "
                  f"{dropped[-1]['err']}", file=sys.stderr)
    if not timed:
        return _apply(pipeline, an, cands[0], params)
    timed.sort(key=lambda it: it[0])
    res = _apply(pipeline, an, timed[0][1], params)
    res["autotuned"] = {
        "samples": len(timed),
        "device": str(dev),
        "best_ms": timed[0][0],
        "times_ms": [t for t, _ in timed],
        "model_rank_of_winner": next(
            i for i, c in enumerate(cands) if c == timed[0][1]),
    }
    if dropped:
        res["autotuned"]["dropped"] = dropped
    if len(timed) > 1 and timed[1][0] < timed[0][0] * 1.15:
        # the top two within 15% of each other: the ranking may be noise
        res["autotuned"]["within_jitter"] = True
    return res


def _li2018(pipeline, target, params):
    """Gradient autoscheduler (reference: src/autoschedulers/li2018/
    GradientAutoscheduler.cpp, apply_schedule @573): a search-free template
    for the many small Funcs reverse-mode autodiff emits. Per func:
    compute_root + parallelize/vectorize the pure loops; for an update
    definition whose pure domain is too small to parallelize, split each
    reduction variable of extent >= 8 by ceil(sqrt(extent) / 8) * 8 (the
    reference's @644-650) and rfactor the outer rvars into a compute_root
    interim func (@683-684) so the reduction gains a parallel axis. rfactor
    itself runs the associativity prover, mirroring the reference's
    prove_associativity gate (@630). The threshold is the JAX package's
    8 * 128 * parallelism points (8192 at the default 8), so that both
    packages write the same schedule: on this card such a domain fills a
    few percent of the 132 SMs' resident threads."""
    from .func import Stage, Var
    from .rdom import RVar
    from .schedule import TailStrategy

    an = _Analysis(pipeline)
    par = int((params or {}).get("parallelism", 8))
    max_domain = 8 * 128 * par
    src: List[str] = []
    engine = BoundsEngine(resolver=lambda n, a: None)

    def _mark_pure(f):
        d = f._defs[0]
        pure = [dm.var for dm in d.schedule.dims if not dm.is_rvar]
        if pure:
            f.vectorize(Var(pure[0]))
            src.append(f"{f.name}.vectorize({pure[0]})")
        if len(pure) >= 2:
            f.parallel(Var(pure[-1]))
            src.append(f"{f.name}.parallel({pure[-1]})")

    for f in an.funcs:
        if f.is_extern() or f._fschedule.compute_level.defined():
            continue
        if id(f) not in an.g.materialized and f not in pipeline.outputs:
            continue                       # stays inlined
        f.compute_root()
        src.append(f"{f.name}.compute_root()")
        _mark_pure(f)
        box = an.boxes.get(id(f))
        domain = 1
        if box is not None and box.defined() and box.bounded():
            for e in box.extents():
                domain *= max(1, int(e))
        for ui, d in enumerate(f._defs[1:]):
            if domain >= max_domain or d.rdom is None:
                continue
            # pure domain too small: expose reduction parallelism by
            # splitting + rfactoring the large rvars
            pairs = []
            stage = Stage(f, ui + 1)
            for rv in list(d.rdom.dims):
                try:
                    if isinstance(rv.rextent, E.IntImm):
                        ext = rv.rextent.value
                    else:
                        iv = engine.bounds(rv.rextent, {})
                        if not iv.is_bounded():
                            continue
                        ext = int(iv.hi)
                except CompileError:
                    continue
                if ext < 8:
                    continue
                split = int(math.ceil(math.sqrt(ext) / 8.0)) * 8
                ro = RVar(name=f"{rv.name}.li_ro")
                ri = RVar(name=f"{rv.name}.li_ri")
                try:
                    stage.split(rv, ro, ri, split,
                                TailStrategy.GuardWithIf)
                except CompileError:
                    continue
                src.append(f"{f.name}.update({ui}).split({rv.name}, "
                           f"{ro.name}, {ri.name}, {split})")
                pairs.append((ro, Var(f"{rv.name}_v")))
            if not pairs:
                continue
            try:
                interim = stage.rfactor(pairs)
            except CompileError:
                continue                   # not associative: leave serial
            interim.compute_root()
            src.append(
                f"{interim.name} = {f.name}.update({ui}).rfactor("
                + ", ".join(f"({r.name}, {v.name})" for r, v in pairs)
                + "); {0}.compute_root()".format(interim.name))
            _mark_pure(interim)
    return {"schedule_source": ";\n".join(src)}


register_autoscheduler("Mullapudi2016", _mullapudi)
register_autoscheduler("Adams2019", _adams)
register_autoscheduler("Li2018", _li2018)
register_autoscheduler("Anderson2021", _anderson2021)

"""Multi-device distribution: the `distribute()` schedule dimension.

The reference is single-node (SURVEY.md §2.6 -- no collectives of any
kind); the JAX package shards over a mesh with `shard_map` and `ppermute`
halos. This module keeps its algorithm and names on a `parallel.Mesh` of
shard slots, from one process: each shard's slab is a slice of the global
tensor moved to its slot's device, its halo rows are its neighbours'
slices moved the same way, and the shards run one after another on torch's
current stream.

v1: row sharding (`sharded_realize_rows`) -- the consumer's y extent is
split across a mesh axis; each shard realizes its slab after receiving
`halo` rows from each neighbour; global edges replicate (repeat_edge
semantics). The halo width must cover the pipeline's y footprint.
v2: `distributed_realize`, the engine of `Func.distribute` + `realize(...,
mesh=...)`: halos from bounds inference on the spatial path, and partials
combined in shard order on the reduction path.
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh


def sharded_realize_rows(build_pipeline, width: int, height: int,
                         mesh: Mesh, axis_name: str, halo: int):
    """Distribute a same-size 2D pipeline across mesh[axis_name] by rows.

    build_pipeline(input_buffer) -> Pipeline: called once per device of
    the axis with a Buffer whose y-min is -halo (rows [-halo, shard+halo)
    are materialized locally); each shard rebinds that Buffer to its own
    slab, so the pipeline's plan is made once and reused.
    Returns fn(global_input[H, W]) -> global_output[H, W], on the device
    of the axis's first slot."""
    from ..buffer import Buffer

    n = mesh.shape[axis_name]
    if height % n != 0:
        raise ValueError(f"height {height} not divisible by mesh axis {n}")
    hs = height // n
    devs = mesh.axis_devices(axis_name)
    per_dev = {}                       # str(device) -> (Buffer, Pipeline)

    def fn(x):
        slabs = [x[i * hs:(i + 1) * hs].to(d) for i, d in enumerate(devs)]
        outs = []
        for i, d in enumerate(devs):
            top, bot = _exchange(slabs, i, halo, halo, 0)
            padded = torch.cat([top, slabs[i], bot], dim=0)
            if str(d) not in per_dev:
                inp = Buffer(padded, name="shard_in").set_min(0, -halo)
                per_dev[str(d)] = (inp, build_pipeline(inp))
            inp, p = per_dev[str(d)]
            inp._data = padded
            out = p.realize([width, hs], jit=False, device=d)
            outs.append((out.data if hasattr(out, "data")
                         else out[0].data).to(devs[0]))
        return torch.cat(outs, dim=0)

    return fn


def _exchange(slabs, i: int, h_lo: int, h_hi: int, npax: int):
    """Halo slabs along tensor axis `npax` for shard i: (top, bottom) with
    asymmetric widths. Interior halos are the neighbours' slices copied to
    shard i's device (the JAX module's ppermute ring); global edges
    replicate the boundary slab (repeat_edge semantics)."""
    x = slabs[i]
    n = len(slabs)

    def take(t, lo, hi):
        return t.narrow(npax, lo, hi - lo)

    def bcast(sl1, h):
        shape = list(x.shape)
        shape[npax] = h
        return sl1.expand(shape)

    top = bot = None
    ext = x.shape[npax]
    if h_lo:
        top = bcast(take(x, 0, 1), h_lo) if i == 0 else \
            take(slabs[i - 1], ext - h_lo, ext).to(x.device)
    if h_hi:
        bot = bcast(take(x, ext - 1, ext), h_hi) if i == n - 1 else \
            take(slabs[i + 1], 0, h_hi).to(x.device)
    return top, bot


def _local_inputs(plans, i: int, devs, slabs_of):
    """Shard i's input tensors: its slab with halos where the input is
    sharded, the whole input on its device where it is replicated."""
    locals_ = []
    for k, plan in enumerate(plans):
        t, buf, sharded, h_lo, h_hi, npax = plan[:6]
        if not sharded:
            locals_.append(buf.data.to(devs[i]))
            continue
        slabs = slabs_of[k]
        x = slabs[i]
        if h_lo or h_hi:
            top, bot = _exchange(slabs, i, h_lo, h_hi, npax)
            x = torch.cat([p for p in (top, x, bot) if p is not None],
                          dim=npax)
        locals_.append(x)
    return locals_


def _shard_runs(pipeline, sizes, plans, dummy_shape, devs):
    """The per-shard program: one `run` per distinct device of the shards,
    prepared by the pipeline (`Pipeline._prepare`: from its plan cache, or
    built and cached there) with every sharded ImageParam set to a dummy --
    zeros on that device, mins shifted by -h_lo (shard-0 coordinates) --
    and set back to the caller's Buffer in a `finally`. The dummies' shapes
    and mins are in the cache key, so a shard program is not served for
    the real inputs, nor the reverse. `dummy_shape(plan)` -> (shape, mins,
    (dim, lo, hi)): the dummy, and the footprint on its sharded dim that
    the pipeline shifted to shard 0 reads (`_check_shift`, when a run is
    built). A sharded input that is a Buffer raises: its bounds are
    constants in the pipeline (a boundary condition on it reads them), so
    no shard could read its slab through them.
    -> ({str(device): run}, the specializations chosen on the dummies)."""
    from ..buffer import Buffer, ImageParam
    from ..expr import CompileError

    for t, _buf, sharded, *_rest in plans:
        if sharded and not isinstance(t, ImageParam):
            raise CompileError(
                f"distribute: input {getattr(t, 'name', '?')} is a Buffer, "
                "whose bounds are constants in the pipeline; bind its data "
                "to an ImageParam to shard it")
    runs = {}
    chosen = []
    for dev in devs:
        if str(dev) in runs:
            continue
        saved = []
        try:
            for plan in plans:
                t, buf, sharded = plan[:3]
                if not sharded:
                    continue
                saved.append((t, t.get()))
                shape, mins, _fp = dummy_shape(plan)
                t.set(Buffer(torch.zeros(shape, dtype=buf.data.dtype,
                                         device=dev),
                             mins=mins, name=buf.name))
            cached = len(pipeline._plan_cache)
            run, chosen, _a, _p, _r = pipeline._prepare(sizes, None, dev,
                                                        memo=False)
            if len(pipeline._plan_cache) > cached:
                try:
                    _check_shift(pipeline, sizes, plans, dummy_shape)
                except CompileError:
                    pipeline._plan_cache.popitem()   # the run just built
                    raise
            runs[str(dev)] = run
        finally:
            for t, was in saved:
                t.set(was)
    return runs, chosen


def _check_shift(pipeline, sizes, plans, dummy_shape):
    """Raise unless every sharded input's footprint, in shard-0
    coordinates with the dummies bound, is on its sharded dim the one that
    the pipeline shifted to shard 0 reads. A bound on that dim that is a
    constant (a clamp to the global extent written by hand) keeps its
    value in every shard, and so reads the wrong rows of a slab."""
    from ..expr import CompileError
    _g, fp = _input_footprints(pipeline, pipeline._out_regions(sizes))
    for plan in plans:
        t, _buf, sharded = plan[:3]
        if not sharded:
            continue
        j, lo, hi = dummy_shape(plan)[2]
        b = fp.get(id(t))
        got = None if b is None or not b.bounded() else \
            (int(b.dims[j].lo), int(b.dims[j].hi))
        if got != (lo, hi):
            raise CompileError(
                f"distribute: input {getattr(t, 'name', '?')} dim {j}: a "
                f"shard reads {got} of its slab where the pipeline shifted "
                f"to it reads {(lo, hi)}; bound that dim by the input's "
                "own extent (a boundary condition), not by a constant")


def _run_shards(runs, chosen, plans, devs, slabs_of):
    """Run every shard's program, one after another, each with its own
    local tensors -> per shard, the flat list of output value tensors."""
    from ..ops.stage_kernel import declining
    from ..specialize import apply_all, restore
    results = []
    undo = apply_all(chosen)
    try:
        for i, dev in enumerate(devs):
            # a shard's whole-array stages stay with eval_torch
            with declining("a sharded realize"):
                out = runs[str(dev)](_local_inputs(plans, i, devs,
                                                   slabs_of))
            # run() returns per-output tuples of value tensors: flatten
            # (tuple-valued Funcs contribute one tensor per tuple member)
            results.append([v for vals in out for v in vals])
    finally:
        restore(undo)
    return results


def _input_footprints(pipeline, regions):
    """Required box of every graph input for the given output regions."""
    from ..bounds import BoundsEngine, Box
    from ..pipeline import _BoundsPass, gather_graph
    g = gather_graph(pipeline.outputs)
    realz = {}
    for t in g.inputs.values():
        buf = t.get() if hasattr(t, "get") else t
        realz[id(t)] = (buf._mins, tuple(buf.data.shape))

    def resolver(name, args):
        if name == "param":
            p = args[0]
            return p.get() if hasattr(p, "get") else None
        r = realz.get(id(args[0]))
        if r is None:
            return None
        mins, shape = r
        i = args[1]
        if name == "buffer_min":
            return mins[i]
        return shape[len(shape) - 1 - i]

    engine = BoundsEngine(resolver=resolver)
    bp = _BoundsPass(g, engine)
    bp.run(pipeline.outputs, {k: Box(list(v.dims))
                              for k, v in regions.items()})
    return g, {id(t): bp.boxes.get(id(t)) for t in g.inputs.values()}


def distributed_realize(pipeline, sizes, mesh: Mesh, axis_name: str,
                        var_name: str):
    """The distribute() schedule directive's engine. Dispatch on what the
    named var is: a pure output dim -> spatial sharding with halo
    exchange (`_distributed_spatial`); a reduction var -> local partials
    combined in shard order (`_distributed_reduce`, the SURVEY §2.6
    plan (b)). Returns a list of per-output global tensors."""
    out0 = pipeline.outputs[0]
    if any(v.name == var_name for v in out0._args):
        dim = [v.name for v in out0._args].index(var_name)
        return _distributed_spatial(pipeline, sizes, mesh, axis_name, dim)
    return _distributed_reduce(pipeline, sizes, mesh, axis_name, var_name)


def _distributed_spatial(pipeline, sizes, mesh: Mesh, axis_name: str,
                         dim: int):
    """Realize `pipeline` with output dim `dim` sharded across
    mesh[axis_name].

    Inputs whose dim-`dim` footprint tracks the shard are sharded with
    bounds-inferred halos (copied from the neighbouring shards, global
    edges replicated); inputs whose footprint is shard-independent are
    replicated whole. Multi-output pipelines shard every output along its
    own dim of the same name (they must all carry it at the same index).
    Non-divisible extents shard at ceil(H/n): sharded inputs are
    edge-padded to n*s (repeat_edge, matching the global-edge halo
    semantics) and outputs are cropped back to H -- the analog of the
    RoundUp tail strategy (every shard runs the same program; the pad is
    at most n-1 rows of overcompute on the last shard). Tuple-valued
    outputs return one tuple of global tensors per output, on the device
    of the axis's first slot."""
    from ..buffer import ImageParam
    from ..bounds import Box, Interval
    from ..expr import CompileError

    n = int(mesh.shape[axis_name])
    devs = mesh.axis_devices(axis_name)
    out_f = pipeline.outputs[0]
    var_name = out_f._args[dim].name
    for fo in pipeline.outputs[1:]:
        names = [v.name for v in fo._args]
        if var_name not in names or names.index(var_name) != dim:
            raise CompileError(
                f"distribute: output {fo.name} must carry dim "
                f"{var_name!r} at position {dim}")
    if isinstance(sizes, int):
        sizes = [sizes]
    H = int(sizes[dim])
    s = -(-H // n)          # ceil: uneven extents pad up, crop after
    Hpad = s * n

    # Halo inference: footprint-probe several shards and take per-side
    # maxima. No single shard is reliable -- an edge shard's footprint is
    # truncated by boundary-condition clamps on its outward side (on a
    # 2-shard mesh EVERY shard is an edge shard), so the first shard
    # supplies the true high-side halo, the last shard the low-side halo,
    # and a middle shard (when one exists) both.
    full_box = Box([Interval(0, int(sz) - 1) for sz in sizes])
    # probe only shards that intersect the REAL domain [0, H): with
    # uneven extents the trailing shard(s) may be pure pad
    last_real = (H - 1) // s
    probe_idx = sorted({0, min(n // 2, last_real), last_real})
    g = None
    probes = []      # (shard_lo, {id(input): Box})
    for pi in probe_idx:
        lo = pi * s
        dims = list(full_box.dims)
        dims[dim] = Interval(lo, min(lo + s - 1, H - 1))
        gi, fp = _input_footprints(
            pipeline, {id(fo): Box(list(dims))
                       for fo in pipeline.outputs})
        g = g or gi
        probes.append((lo, fp))
    _g2, fp_full = _input_footprints(
        pipeline, {id(fo): Box(list(full_box.dims))
                   for fo in pipeline.outputs})

    plans = []       # per input: (obj, buf, sharded?, h_lo, h_hi, npax,
    #                  and where sharded the footprint's offsets lo, hi)
    for t in g.inputs.values():
        buf = t.get() if isinstance(t, ImageParam) else t
        bf = fp_full.get(id(t))
        ndt = buf.data.ndim
        boxes = [(lo, fp.get(id(t))) for lo, fp in probes]
        if bf is None or dim >= ndt or any(
                b is None or not b.bounded() for _lo, b in boxes):
            plans.append((t, buf, False, 0, 0, 0))
            continue
        lo_f, hi_f = int(bf.dims[dim].lo), int(bf.dims[dim].hi)
        # shard-independent footprint (LUTs, transposed reads): replicate
        if all(int(b.dims[dim].lo) == lo_f and int(b.dims[dim].hi) == hi_f
               for _lo, b in boxes):
            plans.append((t, buf, False, 0, 0, 0))
            continue
        # the footprint's offsets from the shard's first and last rows,
        # widest over the probes (a boundary clamp only narrows them)
        lo_off = min(int(b.dims[dim].lo) - shard_lo for shard_lo, b in boxes)
        hi_off = max(int(b.dims[dim].hi) - (shard_lo + s - 1)
                     for shard_lo, b in boxes)
        h_lo, h_hi = max(0, -lo_off), max(0, hi_off)
        if h_lo > s or h_hi > s:
            raise CompileError(
                f"distribute: halo ({h_lo},{h_hi}) wider than the shard "
                f"extent {s} (exchange is single-hop); use fewer shards")
        npax = ndt - 1 - dim
        if buf.data.shape[npax] != H:
            raise CompileError(
                f"distribute: input {getattr(t, 'name', '?')} dim {dim} "
                f"extent {buf.data.shape[npax]} != output extent {H}")
        plans.append((t, buf, True, h_lo, h_hi, npax, lo_off, hi_off))

    def dummy_shape(plan):
        _t, buf, _sh, h_lo, h_hi, npax, lo_off, hi_off = plan
        shape = list(buf.data.shape)
        shape[npax] = s + h_lo + h_hi
        mins = list(buf._mins)
        mins[dim] = -h_lo
        return tuple(shape), tuple(mins), (dim, lo_off, s - 1 + hi_off)

    local_sizes = list(sizes)
    local_sizes[dim] = s
    runs, chosen = _shard_runs(pipeline, local_sizes, plans, dummy_shape,
                               devs)

    def feed(buf, npax):
        x = buf.data
        if Hpad > H:
            # repeat_edge padding up to n*s (matches the global-edge
            # halo semantics; padded output rows are cropped below)
            edge = x.narrow(npax, x.shape[npax] - 1, 1)
            shape = list(x.shape)
            shape[npax] = Hpad - H
            x = torch.cat([x, edge.expand(shape)], dim=npax)
        return x

    slabs_of = {}
    for k, plan in enumerate(plans):
        _t, buf, sharded, _hl, _hh, npax = plan[:6]
        if sharded:
            x = feed(buf, npax)
            slabs_of[k] = [x.narrow(npax, i * s, s).to(d)
                           for i, d in enumerate(devs)]
    per_shard = _run_shards(runs, chosen, plans, devs, slabs_of)

    results = []
    off = 0
    for fo in pipeline.outputs:
        nvals = len(fo._defs[0].values)
        npax_o = fo.dimensions() - 1 - dim
        vals = []
        for v in range(off, off + nvals):
            whole = torch.cat([vs[v].to(devs[0]) for vs in per_shard],
                              dim=npax_o)
            vals.append(whole.narrow(npax_o, 0, H) if Hpad > H else whole)
        off += nvals
        results.append(vals[0] if nvals == 1 else tuple(vals))
    return results


def _static_rint(e):
    from ..expr import CompileError
    from .. import expr as E
    if isinstance(e, int):
        return e
    if isinstance(e, E.IntImm):
        return int(e.value)
    raise CompileError(
        "distribute(rvar): reduction domain bounds must be static ints")


_COMBINE = {"add": torch.add, "min": torch.minimum, "max": torch.maximum}


def combine(partials, op: str, dev):
    """Partials folded in shard order 0..n-1 on `dev` (each copied there,
    then torch.add / minimum / maximum): the counterpart of psum / pmin /
    pmax, whose every shard holds these same bits. -> the result on dev."""
    fold = _COMBINE[op]
    acc = partials[0].to(dev)
    for p in partials[1:]:
        acc = fold(acc, p.to(dev))
    return acc


def _distributed_reduce(pipeline, sizes, mesh: Mesh, axis_name: str,
                        rvar_name: str):
    """f.distribute(r.y, axis): shard the REDUCTION domain across
    mesh[axis_name]. Each shard evaluates the update over its slice of
    the RDom against its slab of the inputs whose footprint tracks the
    slice (others replicate); partials combine in shard order with the
    op (`combine`), and the result comes from shard 0.
    SURVEY §2.6 plan (b); the reference has no multi-node analog.

    v2 scope: the sharded update must be the func's last definition, its
    combine must decompose to an associative op with an identity init,
    and the pipeline output must be the reduction func itself."""
    from ..buffer import Buffer, ImageParam
    from ..bounds import Box, Interval
    from ..expr import CompileError, to_expr
    from ..updates import _decompose_combine, _identity_for
    from .. import expr as E

    n = int(mesh.shape[axis_name])
    devs = mesh.axis_devices(axis_name)
    if len(pipeline.outputs) != 1:
        raise CompileError(
            "distribute(rvar): single-output pipelines only (v2)")
    f = pipeline.outputs[0]
    the_def = rv = None
    for d in f._defs[1:]:
        if d.rdom is not None:
            for rvd in d.rdom.dims:
                if rvd.name == rvar_name:
                    the_def, rv = d, rvd
    if the_def is None:
        raise CompileError(
            f"distribute: {f.name} has no reduction var {rvar_name!r}")
    if the_def is not f._defs[-1]:
        raise CompileError(
            "distribute(rvar): the sharded update must be the last "
            "definition (v2)")

    # the combine must be an associative op whose identity is the init
    # value, so partials composed in shard order equal the serial
    # reduction (the rfactor legality argument, updates._decompose_combine)
    ops = []
    decs = []
    for vi, val in enumerate(the_def.values):
        dec = _decompose_combine(val, f, the_def.args, vi)
        if dec is None:
            raise CompileError(
                "distribute(rvar): update is not a recognized "
                "associative combine (op(self, expr))")
        op = dec[0]
        if op not in ("add", "min", "max"):
            raise CompileError(
                f"distribute(rvar): no collective for op {op!r}")
        ops.append(op)
        decs.append(dec)
        iv = f._defs[0].values[vi]
        ident = _identity_for(op, iv.dtype)
        isv = None
        if isinstance(iv, (E.IntImm, E.FloatImm)):
            isv = iv.value
        if isv is None or float(isv) != float(ident):
            raise CompileError(
                "distribute(rvar): init value must be the combine's "
                f"identity ({ident}) so shard partials compose")

    rmin = _static_rint(rv.rmin)
    rext = _static_rint(rv.rextent)
    chunk = -(-rext // n)   # ceil: uneven extents run a chunk-sized
    # program on every shard; pad iterations contribute the identity
    rpad = chunk * n
    saved_values = None
    if rpad != rext:
        # ceil+mask semantics (the reduction analog of the spatial path's
        # ceil+pad+crop): every shard still runs the same program over
        # `chunk` iterations, and a 0/1 mask input -- sharded with the
        # reduction exactly like any tracking input -- select()s the pad
        # iterations' combine argument to the op's identity: sharded
        # RDoms need no divisibility.
        from ..htypes import Int
        from ..iroperator import select as hselect

        mask_ip = ImageParam(Int(32), 1, "__ht_rmask")
        mask_np = (np.arange(rmin, rmin + rpad)
                   < rmin + rext).astype(np.int32)
        mask_ip.set(Buffer(torch.from_numpy(mask_np), mins=(rmin,),
                           name="__ht_rmask"))
        rv_e = E.Variable(rv.name, Int(32))
        saved_values = list(the_def.values)
        new_vals = []
        for vi, val in enumerate(the_def.values):
            op, gexpr = decs[vi]
            ident = _identity_for(op, gexpr.dtype)
            masked = hselect(mask_ip[rv_e] != 0, gexpr,
                             E.const(ident, gexpr.dtype))
            a_self = isinstance(val.a, E.Call) and val.a.target is f
            if a_self:
                new_vals.append(E.Binary(op, val.a, masked, val.dtype))
            else:
                new_vals.append(E.Binary(op, masked, val.b, val.dtype))
        the_def.values = new_vals

    try:
        # footprint probes with the rvar restricted to shard slices
        # classify each input: dims that shift by chunk-steps shard,
        # others replicate
        if isinstance(sizes, int):
            sizes = [sizes]
        out_box = Box([Interval(0, int(sz) - 1) for sz in sizes])
        probe_idx = sorted({0, n // 2, n - 1})
        saved_dom = (rv.rmin, rv.rextent)

        def probe(lo, ext):
            rv.rmin, rv.rextent = to_expr(lo), to_expr(ext)
            try:
                return _input_footprints(pipeline, {id(f): out_box})
            finally:
                rv.rmin, rv.rextent = saved_dom

        g = None
        probes = []
        for pi in probe_idx:
            gi, fp = probe(rmin + pi * chunk, chunk)
            g = g or gi
            probes.append((pi, fp))
        _gf, fp_full = _input_footprints(pipeline, {id(f): out_box})

        plans = []    # (obj, buf, sharded?, h_lo, h_hi, npax, dimj, and
        #               shard 0's footprint on dimj: lo, hi)
        for t in g.inputs.values():
            buf = t.get() if isinstance(t, ImageParam) else t
            bf = fp_full.get(id(t))
            ndt = buf.data.ndim
            boxes = [(pi, fp.get(id(t))) for pi, fp in probes]
            if bf is None or any(b is None or not b.bounded()
                                 for _pi, b in boxes):
                plans.append((t, buf, False, 0, 0, 0, -1))
                continue
            # find the (single) dim whose footprint tracks the rdom slice
            track = []
            for j in range(min(t.dimensions(), ndt)):
                los = [int(b.dims[j].lo) for _pi, b in boxes]
                his = [int(b.dims[j].hi) for _pi, b in boxes]
                if los[0] == int(bf.dims[j].lo) and \
                        his[0] == int(bf.dims[j].hi) and \
                        all(lo == los[0] for lo in los) and \
                        all(hi == his[0] for hi in his):
                    continue
                track.append((j, los, his))
            if not track:
                plans.append((t, buf, False, 0, 0, 0, -1))
                continue
            if len(track) > 1:
                raise CompileError(
                    f"distribute(rvar): input {getattr(t, 'name', '?')} "
                    "tracks the reduction on more than one dim (v2)")
            j, los, his = track[0]
            npax = ndt - 1 - j
            ext_j = buf.data.shape[npax]
            # per-shard slab width IS the footprint shift between probes
            # (ext_j // n is wrong for uneven extents, where the input is
            # narrower than the n * ceil-chunk sharded span)
            span = probe_idx[-1] - probe_idx[0]
            dim_chunk = (his[-1] - his[0]) // span if span else ext_j
            if dim_chunk <= 0:
                raise CompileError(
                    f"distribute(rvar): input {getattr(t, 'name', '?')} "
                    f"dim {j} footprint does not advance with the "
                    "reduction slice")
            # footprints must shift exactly with the slice
            # (shift-covariant)
            for (pi, _b), lo, hi in zip(boxes, los, his):
                if lo != los[0] + pi * dim_chunk or \
                        hi != his[0] + pi * dim_chunk:
                    raise CompileError(
                        f"distribute(rvar): input "
                        f"{getattr(t, 'name', '?')} dim {j} footprint "
                        "does not shift uniformly with the reduction "
                        "slice")
            need = n * dim_chunk
            if ext_j < need:
                # pad with edge values up to the sharded span: the pad
                # region is only read by mask-discarded iterations, so
                # content is irrelevant -- edge repeat keeps values in the
                # input's range
                edge = buf.data.narrow(npax, ext_j - 1, 1)
                shape = list(buf.data.shape)
                shape[npax] = need - ext_j
                buf = Buffer(torch.cat([buf.data, edge.expand(shape)],
                                       dim=npax),
                             mins=buf._mins, name=buf.name)
            elif ext_j > need:
                raise CompileError(
                    f"distribute(rvar): input {getattr(t, 'name', '?')} "
                    f"dim {j} extent {ext_j} exceeds the sharded span "
                    f"{need}")
            mn_j = int(buf._mins[j])
            h_lo = max(0, mn_j - los[0])
            h_hi = max(0, his[0] - (mn_j + dim_chunk - 1))
            if h_lo > dim_chunk or h_hi > dim_chunk:
                raise CompileError(
                    "distribute(rvar): reduction halo wider than the shard")
            plans.append((t, buf, True, h_lo, h_hi, npax, j, los[0],
                          his[0]))

        def dummy_shape(plan):
            _t, buf, _sh, h_lo, h_hi, npax, j, lo0, hi0 = plan
            shape = list(buf.data.shape)
            shape[npax] = shape[npax] // n + h_lo + h_hi
            mins = list(buf._mins)
            mins[j] = mins[j] - h_lo
            # shard 0's coordinates are the global ones on this path
            return tuple(shape), tuple(mins), (j, lo0, hi0)

        # per-shard program: rvar restricted to its local slice, sharded
        # inputs bound to local slabs (shard-0 coordinates;
        # shift-covariance makes the same program correct on every
        # shard). The program resolves RDom bounds when it is called, so
        # the rvar stays changed until every shard has run.
        rv.rmin, rv.rextent = to_expr(rmin), to_expr(chunk)
        try:
            runs, chosen = _shard_runs(pipeline, sizes, plans,
                                       dummy_shape, devs)
            slabs_of = {}
            for k, plan in enumerate(plans):
                _t, buf, sharded, _hl, _hh, npax = plan[:6]
                if sharded:
                    w = buf.data.shape[npax] // n
                    slabs_of[k] = [buf.data.narrow(npax, i * w, w).to(d)
                                   for i, d in enumerate(devs)]
            per_shard = _run_shards(runs, chosen, plans, devs, slabs_of)
        finally:
            rv.rmin, rv.rextent = saved_dom
    finally:
        if saved_values is not None:
            the_def.values = saved_values
    res = tuple(combine([vs[v] for vs in per_shard], op, devs[0])
                for v, op in enumerate(ops))
    return [res[0] if len(res) == 1 else res]

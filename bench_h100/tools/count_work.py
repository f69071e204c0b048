"""Count the frozen work of each configuration at each of its sizes, once,
from the algorithm and the pinned schedule, and write it into the
configuration's file (`work`), where the benchmark reads it:

    python3 -m bench_h100.tools.count_work [--write]

It realizes each configuration once on the card at each of its sizes (the
tests call `count` on the CPU at a small size) and counts:

- `k1`: the stencil-group kernel K1's group. Bytes: each external input
  (window) over the region the group needs of it, the union of every
  sub-tile's staged box clipped to the realized array, read once, and the
  output written once. Operations: the output's point operations at each
  output point, and each member's at each output (x, y) point times its
  static dims (local_laplacian's 8 planes), without the halo the kernel
  computes again; f32 and integer apart.
- `frame`: the whole frame. Bytes: the app's inputs and its output, each
  once. Operations: each materialized stage's point operations (its inline
  producers substituted in, as the schedule computes them) over the box the
  bounds pass gives it, the K1 group's members included.

An operation is one node of the expression, counted by its operands' type
(the port's `group_kernel.point_ops`): the coordinate arithmetic of an
index is not counted unless the index depends on data, a cast and a bit
cast not at all, a shared subexpression once. Known undercounts, each of
which makes a share lower and never higher: a libm call (exp, pow) and a
lerp count as one operation, an integer division as one (the card has no
divide unit), 16-bit integer arithmetic as one where the card does two, and
whatever nvcc folds or the kernel recomputes in its halo is not counted.
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from bench_h100.frames import build_app, make_inputs, Stream
from bench_h100.spec import HERE, Cell, load_json


def window_bytes(plan, inputs, rmins) -> int:
    """Bytes of the inputs a group must read: each window's footprint over
    all sub-tiles (the union of its staged boxes), within the realized
    array, read once (the port's chip check's `window_bytes`)."""
    from halide_tpu_torch.ops import group_kernel as gk
    origins = list(gk._origins(plan))
    total = 0
    for w, arr, rmin in zip(plan.windows, inputs, rmins):
        boxes = [gk._stage_box(w, x0, y0) for x0, y0 in origins]
        n = 1
        for j in range(len(w.dims)):
            size = arr.shape[arr.ndim - 1 - j]
            lo = max(min(b[j][0] for b in boxes), rmin[j])
            hi = min(max(b[j][0] + b[j][1] - 1 for b in boxes),
                     rmin[j] + size - 1)
            n *= max(hi - lo + 1, 0)
        total += n * arr.element_size()
    return total


def group_ops(plan):
    """(f32, integer) operations of the group: the output's at each of its
    points, each member's at each output (x, y) point times its static
    dims (the port's chip check's `count_ops`, without update passes: the
    configurations here have no update definitions)."""
    from halide_tpu_torch.ops import group_kernel as gk
    if any(m.updates for m in plan.members):
        raise NotImplementedError("a member with update definitions")
    per_xy = plan.extents[plan.xi] * (
        plan.extents[plan.yi] if plan.yi is not None else 1)
    f32, i = (v * math.prod(plan.extents) for v in gk.point_ops(plan.value))
    for m in plan.members:
        mf, mi = gk.member_ops(m)
        static = math.prod(e for k, _d, _o, e in m.dims if k == "s")
        f32 += mf * per_xy * static
        i += mi * per_xy * static
    return int(f32), int(i)


def frame_ops(pipeline):
    """(f32, integer) operations of every materialized stage over its box in
    the pipeline's last realize."""
    from halide_tpu_torch.ops import group_kernel as gk
    from halide_tpu_torch.pipeline import gather_graph
    planned = list(pipeline._plan_cache.values())[-1].planned
    g = gather_graph(pipeline.outputs)
    f32 = i = 0
    for f in g.funcs:
        box = planned["boxes"].get(id(f))
        if id(f) not in g.materialized or box is None or not box.defined():
            continue
        points = math.prod(box.extents())
        for k, d in enumerate(f._defs):
            vals = [gk._inline_expand(v) for v in d.values]
            mf, mi = gk.point_ops(vals)
            reps = gk.rdom_points(d) if k else 1
            f32 += mf * points * reps
            i += mi * points * reps
    return int(f32), int(i)


def count(cell: Cell, device) -> dict:
    from halide_tpu_torch.ops import group_kernel as gk
    dev = torch.device(device)
    inputs = make_inputs(cell, 0, dev, frames=1)
    app = build_app(cell)
    stream = Stream(app, inputs, dev)
    stream.frame()
    out = stream.last.data
    calls = gk.group_calls(app.pipeline, dev)
    k1 = {"bytes": 0, "f32_ops": 0, "int_ops": 0, "launches": len(calls)}
    for plan, arrs, rmins, _params, _realz in calls:
        out_bytes = math.prod(plan.extents) * torch.empty(
            (), dtype=gk.torch_dtype(plan.out_type)).element_size()
        k1["bytes"] += window_bytes(plan, arrs, rmins) + out_bytes
        f32, i = group_ops(plan)
        k1["f32_ops"] += f32
        k1["int_ops"] += i
    frame_in = sum(t[0].numel() * t.element_size()
                   for t in inputs.ring.values()) + sum(
        t.numel() * t.element_size() for t in inputs.fixed.values())
    f32, i = frame_ops(app.pipeline)
    frame = {"bytes": int(frame_in + out.numel() * out.element_size()),
             "f32_ops": f32, "int_ops": i}
    work = {"frame": frame}
    if calls:
        work["k1"] = k1
    return work


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="write each count into its configuration's file")
    a = ap.parse_args(argv)
    for path in sorted((HERE / "configs").glob("*.json")):
        config = load_json(path)
        work = {}
        for size_class, size in config["sizes"].items():
            cell = Cell(f"{config['name']}.{size_class}", 1, config,
                        {"size": size_class}, list(size), {})
            work[size_class] = count(cell, "cuda")
            print(json.dumps({"config": config["name"], "size": size_class,
                              "work": work[size_class]}), flush=True)
        if a.write:
            config["work"] = work
            path.write_text(json.dumps(config, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

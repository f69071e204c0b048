"""Count the frozen work of the granite_4_h_micro configuration at each of
its sizes and write it into the configuration's file (`work`):

    python3 -m bench_h100.tools.count_granite [--write]

Nothing is realized: the app is built at the size, its inputs bound as
meta tensors of their shapes, and the bounds pass gives each stage's box.

- `frame`: the whole realize. Bytes: the tokens, every weight and the
  logits, each once. Operations: every stored stage's point operations
  over its box (`count_work`'s rule: an inline sum's value at each point
  of its RDom and one add a point).
- `contract`: the library contractions (cuBLAS through the einsum path):
  each projection, norm's sum of squares, the SSD's chunk products,
  attention's two products over the full square and the LM head; the
  sums that eval_torch lowers to an einsum, over the boxes the bounds
  pass gives (the last layer's MLP and mixer output at the last position
  only, the last chunk's state not at all). Operations: each one's
  multiply-adds as 2 f32 operations. Bytes: the region each reads of each
  operand, and the result, once.
- `scan`: the scan kernel K2b, once a Mamba-2 mixer: its coefficients a
  and terms b read once and its states y written once (the entering
  states of chunks 1 to NC-1), 2 f32 operations (a multiply-add) an
  element.

Each count follows the program's own work, not the least the function
needs: attention's products over the whole square, the masked half too,
and K2b's coefficient as the program holds it, one value an element
(not one a head and chunk). Both raise the least times a little, and
with them `gemm_roofline` and `scan_roofline`.
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from bench_h100.spec import HERE, Cell, load_json
from bench_h100.tools.granite_config import dumps

F32_BYTES = 4


def contractions(app) -> list:
    """(stage, multiply-adds, operand elements, result elements) of every
    inline sum that the port lowers to the einsum path (eval_torch's
    rule: a float sum of a product, no predicate, over a grid of the
    stage's box times the RDom's points of at least its threshold), over
    the boxes the bounds pass gives; an operand's elements are the region
    the sum reads of it."""
    from halide_tpu_torch import expr as E
    from halide_tpu_torch.bounds import BoundsEngine
    from halide_tpu_torch.eval_torch import _EINSUM_MIN_FULL, _factors
    from halide_tpu_torch.ops.group_kernel import rdom_extent
    from halide_tpu_torch.pipeline import _resolver
    from halide_tpu_torch.visitors import walk
    g, boxes, realz = planned_boxes(app)
    engine = BoundsEngine(resolver=_resolver(realz, {}))
    out = []
    for f in g.funcs:
        box = boxes.get(id(f))
        if id(f) not in g.materialized or box is None or not box.defined():
            continue
        outputs = math.prod(box.extents())
        scope = {v.name: box.dims[i] for i, v in enumerate(f._args)}
        sums = []
        walk(f._defs[0].values[0], lambda n: sums.append(n) if isinstance(
            n, E.Reduce) and n.op == "sum" else None)
        for r in sums:
            factors = _factors(r.value)
            pts = math.prod(rdom_extent(rv) for rv in r.rdom.dims)
            if len(factors) < 2 or r.where is not None or \
                    r.rdom.predicates or not r.value.dtype.is_float() or \
                    outputs * pts < _EINSUM_MIN_FULL:
                continue
            inner = engine.rdom_scope(r.rdom, scope)
            operands = 0
            for fct in factors:
                if isinstance(fct, E.Call):
                    ivs = [engine.bounds(a, inner) for a in fct.args]
                    operands += math.prod(iv.hi - iv.lo + 1 for iv in ivs)
            out.append((f.name, outputs * pts, operands, outputs))
    return out


def contract_work(app) -> dict:
    parts = contractions(app)
    return {"bytes": F32_BYTES * sum(o + r for _n, _m, o, r in parts),
            "f32_ops": 2 * sum(m for _n, m, _o, _r in parts),
            "int_ops": 0, "contractions": len(parts)}


def scan_work(a: dict, seq: int, batch: int) -> dict:
    nc = seq // a["mamba_chunk_size"]
    lines = a["mamba_n_heads"] * a["mamba_d_head"] * a["mamba_d_state"] \
        * batch
    mixers = sum(k == "mamba" for k in a["layer_types"])
    n = mixers * lines * (nc - 1)
    return {"bytes": 3 * F32_BYTES * n, "f32_ops": 2 * n, "int_ops": 0,
            "launches": mixers if nc > 1 else 0}


def planned_boxes(app):
    """Each stage's box by the bounds pass over the inputs as they are
    bound (meta tensors do): -> (the Func graph, the boxes, the inputs'
    realizations)."""
    from halide_tpu_torch.eval_torch import Realized
    from halide_tpu_torch.pipeline import gather_graph
    pipe = app.pipeline
    g = gather_graph(pipe.outputs)
    realz = {id(t): Realized((t.get().data,), t.get()._mins, t.name)
             for t in g.inputs.values()}
    regions = pipe._out_regions(app.output_sizes)
    return g, pipe._bounds(g, regions, realz, {}), realz


def frame_ops(app) -> tuple:
    """(f32, integer) operations of every stored stage over its box."""
    from halide_tpu_torch.ops import group_kernel as gk
    g, boxes, _realz = planned_boxes(app)
    f32 = i = 0
    for f in g.funcs:
        box = boxes.get(id(f))
        if id(f) not in g.materialized or box is None or not box.defined():
            continue
        points = math.prod(box.extents())
        for k, d in enumerate(f._defs):
            mf, mi = gk.point_ops([gk._inline_expand(v) for v in d.values])
            reps = gk.rdom_points(d) if k else 1
            f32 += mf * points * reps
            i += mi * points * reps
    return int(f32), int(i)


def count(cell: Cell) -> dict:
    """The work of `cell`'s configuration at its size."""
    from bench_h100.frames import build_app, resolve_shape
    app = build_app(cell)
    nbytes = 0
    for spec, param in zip(cell.config["inputs"], app.inputs):
        shape = resolve_shape(spec["shape"], cell.size)
        t = torch.empty(shape, dtype=getattr(torch, spec["dtype"]),
                        device="meta")
        param.set(t)
        nbytes += t.numel() * t.element_size()
    seq, batch = cell.size
    nbytes += F32_BYTES * app.params.vocab * batch           # the logits
    f32, i = frame_ops(app)
    return {"frame": {"bytes": nbytes, "f32_ops": f32, "int_ops": i},
            "contract": contract_work(app),
            "scan": scan_work(cell.config["args"], seq, batch)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="write the count into the configuration's file")
    a = ap.parse_args(argv)
    path = HERE / "configs" / "granite_4_h_micro.json"
    config = load_json(path)
    work = {}
    for size_class, size in config["sizes"].items():
        cell = Cell(f"{config['name']}.{size_class}", 1, config,
                    {"size": size_class}, list(size), {})
        work[size_class] = count(cell)
        print(json.dumps({"config": config["name"], "size": size_class,
                          "work": work[size_class]}), flush=True)
    if a.write:
        config["work_method"] = "bench_h100/tools/count_granite.py"
        config["work"] = work
        path.write_text(dumps(config))
    return 0


if __name__ == "__main__":
    sys.exit(main())

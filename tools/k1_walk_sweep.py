"""Sweeps of the stencil-group kernel (K1) on the card: sub-tile x threads
and the staging split.

    python tools/k1_walk_sweep.py [--out F]  # both, then the fit
    python tools/k1_walk_sweep.py --fit F    # only the fit, from a saved F
    python tools/k1_walk_sweep.py --pow      # nl_means: x * x against powf

At the canonical sizes of `chip_smoke.py`, for stencil_chain's first and
last groups (1536x2560 u16, 32 stencils), camera_pipe (2560x1920, tile
2560x128), linear_blur (1536x2560x3 f32), local_laplacian (1536x2560x3
u16), blur (2560x1536 u16), interpolate (1536x2560x4 f32) and
stencil_chain's slide=512 branch (its four groups, 15 members each):

- sub-tile x threads: each group planned again at sub-tiles from 32x16 to
  256x64 and 128x128 (`SUB_TILES`), and 128, 256, 512 and 1024 threads a
  block (where they fit the 227 KB a block can take), every point built
  (all builds started together), checked equal to the planned kernel's
  output and timed. Then the fit: the planner's order
  (`group_kernel.plan_key`) ranks each group's points for a grid of its
  three constants (`_WARPS_FULL`, `_BYTE_OPS`, `_SYNC`), and the triple
  whose picks lose least against each group's fastest point (the geometric
  mean of the time ratios) is printed;
- the staging split: the planned kernel against the same plan built to
  only stage its windows, and to only compute (from whatever shared memory
  holds), for the bytes-bound groups (blur, linear_blur, interpolate,
  local_laplacian) and stencil_chain's last and camera_pipe's;
- pow (`--pow` runs only this): nl_means's box sums (1536x2560x3 f32,
  patch 7, search 7, tile 256x64) with `pow(a - b, 2.0)` compiled as
  x * x, what eval_torch and the kernel compute (as XLA's simplifier does
  for the JAX package), and as libdevice's general powf, what a literal
  translation of the intrinsic emits: the same plan (sub-tile, threads)
  and inputs, each build held against its own plain version (eval_torch
  computing pow the same way) on the first band's sub-tile rows, and timed
  in turns (x * x, powf, powf, x * x).

Needs one CUDA card; prints the card's name and power limit, ptxas's report
(registers, spills) of each planned build, one JSON line per group and
sweep, and the fit. The full point list goes to `--out` (by default
build/k1_sweep.json).
Times are CUDA-event medians of 30 launches with L2 flushed between them,
the card held while the host enqueues (chip_smoke.event_ms).
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SUB_TILES = [(32, 16), (64, 16), (128, 16), (256, 16), (32, 32), (64, 32),
             (32, 64), (64, 64), (128, 32), (128, 64), (32, 128), (64, 128),
             (128, 128), (256, 32), (256, 64)]
WARPS_FULL = (4, 8, 12, 16, 24, 32, 48, 64)
BYTE_OPS = (0.0, 1.0, 2.5, 5.0, 7.5, 10.0, 15.0, 20.0, 40.0)
SYNC = (0.0, 2e3, 3.2e4, 1.28e5, 2.56e5, 5.12e5, 1e6, 2e6, 4e6)


def fit(groups):
    """-> (the best (_WARPS_FULL, _BYTE_OPS, _SYNC), its geometric-mean
    loss, the loss of every triple, and each group's pick at the best)."""
    from halide_tpu_torch.ops import group_kernel as gk
    saved = gk._WARPS_FULL, gk._BYTE_OPS, gk._SYNC
    losses = {}
    try:
        for w, b, y in itertools.product(WARPS_FULL, BYTE_OPS, SYNC):
            gk._WARPS_FULL, gk._BYTE_OPS, gk._SYNC = w, b, y
            logs = []
            for g in groups:
                pts = g["points"]
                best = min(p["ms"] for p in pts)
                pick = min(pts, key=lambda p: gk.plan_key(p["terms"]))
                logs.append(math.log(pick["ms"] / best))
            losses[(w, b, y)] = math.exp(sum(logs) / len(logs))
        wb = min(losses, key=lambda k: (losses[k], k))
        gk._WARPS_FULL, gk._BYTE_OPS, gk._SYNC = wb
        picks = {g["name"]: min(g["points"],
                                key=lambda p: gk.plan_key(p["terms"]))
                 for g in groups}
    finally:
        gk._WARPS_FULL, gk._BYTE_OPS, gk._SYNC = saved
    return wb, losses[wb], losses, picks


def print_fit(groups, saved_rule):
    wb, loss, losses, picks = fit(groups)
    print(json.dumps({"fit": {"warps_full": wb[0], "byte_ops": wb[1],
                              "sync": wb[2], "loss": loss,
                              "loss_of_the_rule_as_built": losses.get(
                                  saved_rule),
                              "picks": {n: [p["sub_tile"], p["threads"],
                                            p["ms"]]
                                        for n, p in picks.items()},
                              "fastest": {g["name"]: min(
                                  ([p["sub_tile"], p["threads"], p["ms"]]
                                   for p in g["points"]),
                                  key=lambda q: q[2]) for g in groups}}}),
          flush=True)


def sweep_pow(cs, gk, time_of):
    """nl_means's group built with pow(x, 2) as x * x (as planned) and as
    powf (`pow_is_square` off in the emitter and the plain version alike,
    for this build only), each against its own plain version on the first
    band's sub-tile rows, then timed in turns. -> one JSON-able dict."""
    from halide_tpu_torch import eval_torch
    from halide_tpu_torch.apps import nl_means
    app = nl_means.build(1536, 2560)
    app.bind(app.make_inputs(0))
    app.realize()
    (plan, inputs, rmins, params, _r), = gk.group_calls(app.pipeline)
    rows = set(range(gk._cdiv(plan.ty, plan.sy)))
    sel = torch.tensor(gk.plain_rows(plan, rows), device=inputs[0].device)
    dim = len(plan.extents) - 1 - plan.yi

    def versus_plain(p):
        kern = gk.launch(p, inputs, rmins).index_select(dim, sel)
        plain = gk.run_plain(p, inputs, rmins, params, inputs[0].device,
                             rows)
        return (kern.double() - plain.index_select(dim, sel).double()
                ).abs().max().item()
    kept = (gk.pow_is_square, eval_torch.pow_is_square)
    gk.pow_is_square = eval_torch.pow_is_square = lambda e: False
    try:
        (powf, *_x), = gk.group_calls(app.pipeline, replan=lambda p: [
            dict(sub_tile=(plan.sx, plan.sy), threads=plan.threads)])
        err_powf = versus_plain(powf)
    finally:
        gk.pow_is_square, eval_torch.pow_is_square = kept
    err_mul = versus_plain(plan)
    t_mul = [time_of(plan, inputs, rmins)]
    t_powf = [time_of(powf, inputs, rmins) for _ in range(2)]
    t_mul.append(time_of(plan, inputs, rmins))
    return {"plan": {k: plan.record()[k] for k in (
                "sub_tile", "threads", "grid", "smem_bytes")},
            "x_times_x": {"ms": t_mul, "max_abs_err_vs_plain": err_mul},
            "powf": {"ms": t_powf, "max_abs_err_vs_plain": err_powf}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fit", help="a k1_sweep.json to fit the rule to")
    ap.add_argument("--pow", action="store_true",
                    help="only nl_means's group with x * x against powf")
    ap.add_argument("--out", default=str(ROOT / "build" / "k1_sweep.json"),
                    help="where to write the sweep's points")
    args = ap.parse_args()
    from halide_tpu_torch.ops import group_kernel as gk
    rule = (gk._WARPS_FULL, gk._BYTE_OPS, gk._SYNC)
    if args.fit:
        print_fit(json.loads(Path(args.fit).read_text())["groups"], rule)
        return
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as cs
    from halide_tpu_torch.apps import (blur, camera_pipe, interpolate,
                                       linear_blur, local_laplacian,
                                       stencil_chain)
    from halide_tpu_torch.ops import build
    print(cs.card_line(), flush=True)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def time_of(plan, inputs, rmins):
        return cs.event_ms(lambda: gk.launch(plan, inputs, rmins), 30,
                           scratch.zero_, hold=True)
    if args.pow:
        print(json.dumps({"pow": sweep_pow(cs, gk, time_of)}), flush=True)
        return
    # (name, maker, which group calls, sub-tile sweep, split)
    apps = [
        ("stencil_chain", lambda: stencil_chain.build(1536, 2560, 32,
                                                      kernel=True),
         (0, 3), True, (3,)),
        ("camera_pipe", lambda: camera_pipe.build(2560, 1920, kernel=True,
                                                  tile=(2560, 128)),
         (0,), True, (0,)),
        ("linear_blur", lambda: linear_blur.build(1536, 2560), (0,), True,
         (0,)),
        ("local_laplacian", lambda: local_laplacian.build(1536, 2560), (0,),
         True, (0,)),
        ("blur", lambda: blur.build(2560, 1536, tile=(256, 128)), (0,),
         True, (0,)),
        ("interpolate", lambda: interpolate.build(1536, 2560), (0,), True,
         (0,)),
        ("stencil_chain_slide512", lambda: stencil_chain.build(
            1536, 2560, 32, slide=512), (0, 1, 2, 3), True, ()),
    ]
    # plan every point first, then build them all together
    work = []          # (label, planned call, [(kind, key, plan)])
    for name, make, which, sweep, split in apps:
        app = make()
        app.bind(app.make_inputs(0))
        app.realize()
        calls = gk.group_calls(app.pipeline)
        for ci in sorted(set(which) | set(split)):
            plan, inputs, rmins, params, _r = calls[ci]
            kws = []
            if ci in which and sweep:
                kws += [dict(sub_tile=tuple(c["sub_tile"]),
                             threads=c["threads"])
                        for c in plan.candidates
                        if tuple(c["sub_tile"]) in SUB_TILES]
            if ci in split:
                kws += [dict(sub_tile=(plan.sx, plan.sy),
                             threads=plan.threads, part=part)
                        for part in ("stage", "compute")]
            variants = [
                ("split" if q.part != "all" else "point",
                 q.part if q.part != "all" else (q.sx, q.sy, q.threads), q)
                for q, *_x in gk.group_calls(
                    app.pipeline,
                    replan=lambda p, f=plan.f, kws=kws: kws if p.f is f
                    else [])]
            work.append((f"{name}/{plan.f.name}",
                         (plan, inputs, rmins, params), variants))
    plans = {}
    for _label, (plan, *_r), variants in work:
        plans[plan.symbol] = plan
        for _k, _key, q in variants:
            plans[q.symbol] = q
    print(f"{len(plans)} sources to build", flush=True)
    with ThreadPoolExecutor(8) as pool:
        for f in [pool.submit(gk.build, p) for p in plans.values()]:
            f.result()
    report = {"card": cs.card_line(), "rule": list(rule), "groups": [],
              "split": []}
    for label, (plan, inputs, rmins, _params), variants in work:
        print(json.dumps({"group": label, "planned": plan.record(),
                          "ptxas": build.ptxas.get(plan.symbol, [])}),
              flush=True)
        want = gk.launch(plan, inputs, rmins)
        t_plan = time_of(plan, inputs, rmins)
        points = []
        for kind, vkey, q in variants:
            if kind != "point":
                continue
            if not torch.equal(gk.launch(q, inputs, rmins), want):
                sys.exit(f"{label}: sub-tile {vkey} changes the values")
            terms = next(c for c in q.candidates
                         if c["threads"] == vkey[2])
            points.append({"sub_tile": list(vkey[:2]), "threads": vkey[2],
                           "ms": time_of(q, inputs, rmins),
                           "terms": terms,
                           "ptxas": build.ptxas.get(q.symbol, [])})
        if points:
            report["groups"].append({"name": label, "planned_ms": t_plan,
                                     "planned": [plan.sx, plan.sy,
                                                 plan.threads],
                                     "points": points})
            fast = min(points, key=lambda p: p["ms"])
            print(json.dumps({"sweep": label, "planned": [
                plan.sx, plan.sy, plan.threads, t_plan], "fastest": [
                fast["sub_tile"], fast["threads"], fast["ms"]],
                "points": [[p["sub_tile"], p["threads"], round(p["ms"], 4)]
                           for p in points]}), flush=True)
        parts = {k: q for kind, k, q in variants if kind == "split"}
        if parts:
            ms = {"all": t_plan}
            ms.update({k: time_of(q, inputs, rmins) for k, q in parts.items()})
            ms["all_again"] = time_of(plan, inputs, rmins)
            report["split"].append({"group": label, "ms": ms})
            print(json.dumps({"split": label, "ms": ms}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report))
    print_fit(report["groups"], rule)


if __name__ == "__main__":
    main()

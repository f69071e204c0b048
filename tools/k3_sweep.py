"""Sweep of the row-histogram kernel (K3) on the card, and the fit of its
plan rule.

    python tools/k3_sweep.py [--out F] [--parent-source CU]  # sweep, fit
    python tools/k3_sweep.py --fit F     # only the fit, from a saved F

Inputs (`chip_smoke.k3_inputs`), K = 256 but where named: hist's lin (2560
x 1536 int32, captured from a realize of hist at 1536x2560x3), the same
values in the transposed layout (rows_fast), offset by one element (a head
of three elements a row before the 16-byte loads), cut to 1535 columns
(4-byte loads), the one-bin and ramp inputs at that shape, uniform bins in
256 rows of 65,536 (long_rows) and in 64 rows of 262,144 (cluster), and
hist's lin with K = 1024 (k1024). The fit uses every input but `HELD_OUT`
(offset, k1024), on which the fitted rule's loss is reported apart.

Points, each launched once, held against the plain version (exact) and
timed. All but the last three groups run on a build of every loads-in-flight
count at every unit (ROWHIST_ALL_INFLIGHT), of which the default build holds
the rule's and the first design's kernels:
- geometry: rows a block x threads x loads in flight at the widest unit
  (hist and odd_width, hist also at a cluster of 2; offset and k1024, for
  their fastest point; rows_fast, long_rows and cluster also at clusters
  of 1, 2, 4 and 8);
- the load unit, 4, 8 and 16 bytes, at the rule's plan, and on hist at
  each loads-in-flight count;
- contention: 1, 2, 4 and 8 counter copies at the rule's plan, on hist,
  one_bin and ramp;
- the first design's geometry (8 rows, 256 threads, 4-byte loads) at 1, 2,
  4 and 8 loads in flight, on every input;
- warp aggregation: a build whose lanes count through __match_any_sync
  (one atomicAdd of the run length per distinct counter), at the rule's
  plan with 1 and 2 copies, on hist, one_bin and ramp;
- registers: a build whose kernels may take 64 registers a thread
  (`__launch_bounds__(1024, 1)`) at the rule's plan, at the 4-byte unit and
  at the first design's geometry, on every input;
- with `--parent-source`, the kernel of an earlier source (the first design:
  8 rows, 256 threads, one loop of 4-byte loads and atomics; its C entry
  point `rowhist(lin, srow, sp, R, P, K, g, out, rows_fast, stream)`) on
  every input.
Then the parts, on hist's lin: the rule's plan, the builds with counting
compiled out (load_only) and the loads too (merge_only), the first design's
geometry, a copy of lin and a fill of the counts' bytes (torch
yardsticks), each after the usual flush (64 MB written: L2 left full of
dirty lines, which a kernel's reads evict and write back) and after a clean
one (64 MB read), in turns; and each one's device time from torch.profiler
(CUDA events add a few microseconds of their own).

The fit: for each combination of the rule's constants on a grid (`GRID`),
the rule plans every input; each distinct plan not yet swept is timed (and
checked) too. The combination whose plans lose least against each input's
fastest timed point (the geometric mean of the time ratios) over the fitted
inputs is printed, with its loss per input, its loss on the held-out
inputs, and the loss of the rule as built. With `--fit`, only plans in the
file count (a combination with an untimed plan is left out).

Needs one CUDA card; prints the card's name and power limit, one JSON line
per input and the fit, and writes every point to `--out` (by default
build/k3_sweep.json). Times are CUDA-event medians of 30 launches with L2
flushed between them, the card held while the host enqueues
(chip_smoke.event_ms).
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

K = 256
K_OF = {"k1024": 1024}
HELD_OUT = ("offset", "k1024")
GRID = dict(values=(2, 4, 8, 16), rounds=(1, 2, 3, 4), rf_rows=(8, 16, 32),
            waves=(0.5, 1, 2), copies=(1, 2))
# the variants' source patches
COUNT_ONE = "if (kk >= 0) atomicAdd(&cnt[kk], 1);"
MATCH = ("{ const unsigned peers = __match_any_sync(__activemask(), kk); "
         "if (kk >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1) "
         "atomicAdd(&cnt[kk], __popc(peers)); }")
BOUNDS = "__launch_bounds__(1024, W * L <= 8 ? 2 : 1)"


def key(plan):
    from halide_tpu_torch.ops import rowhist_kernel as rk
    return tuple(plan[f] for f in rk.PLAN_FIELDS)


def occupancy_key(plan):
    """What a plan's blocks an SM depend on."""
    return tuple(plan[f] for f in ("unit", "inflight", "threads",
                                   "smem_bytes"))


def fit(inputs, timed, time_plan=None):
    """-> the best constants, their loss over the fitted inputs, their loss
    per input (held-out ones too) and the loss of the rule as built.
    `timed[name]` maps plan keys to ms; `time_plan(name, plan)` times a
    plan not in it (None: such a combination is skipped)."""
    from halide_tpu_torch.ops import rowhist_kernel as rk
    saved = dict(rk._RULE)
    names = sorted(inputs)
    fitted = [n for n in names if n not in HELD_OUT]
    results = {}
    try:
        for combo in itertools.product(*GRID.values()):
            rk._RULE.update(zip(GRID, combo))
            ratios = {}
            for n in names:
                inp = inputs[n]
                plan = rk.plan_rowhist(*inp["shape"], inp["K"],
                                       inp["layout"], None, inp["resident"])
                ms = timed[n].get(key(plan))
                if ms is None and time_plan is not None:
                    ms = time_plan(n, plan)
                if ms is None:
                    break
                ratios[n] = ms
            else:
                results[combo] = ratios
    finally:
        rk._RULE.clear()
        rk._RULE.update(saved)
    best_ms = {n: min(timed[n].values()) for n in names}

    def loss(ratios, among):
        return math.exp(sum(math.log(ratios[n] / best_ms[n]) for n in among)
                        / len(among))
    best = min(results, key=lambda c: (loss(results[c], fitted), c))
    built = tuple(saved[k] for k in GRID)
    out = dict(constants=dict(zip(GRID, best)),
               loss=loss(results[best], fitted),
               held_out_loss=loss(results[best], HELD_OUT),
               per_input={n: results[best][n] / best_ms[n] for n in names})
    if built in results:
        out.update(loss_of_the_rule_as_built=loss(results[built], fitted),
                   held_out_loss_of_the_rule_as_built=loss(results[built],
                                                           HELD_OUT),
                   per_input_of_the_rule_as_built={
                       n: results[built][n] / best_ms[n] for n in names})
    return out


def prof_us(fn, flush, name):
    """Median device time (us) of the kernels whose name holds `name` over
    7 calls of fn(), each after flush(), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(7):
            flush()
            fn()
        torch.cuda.synchronize()
    us = sorted(e.time_range.elapsed_us() for e in prof.events()
                if name in e.name)
    return us[len(us) // 2]


def parts_study(cs, rk, lin, scratch, parts):
    """On hist's lin: the rule's plan, the load-only and merge-only builds
    at that plan, the first design's geometry (and its load-only build),
    and two torch yardsticks (a copy of lin, which reads and writes its
    bytes; a fill of the counts' 2.6 MB) -> CUDA-event ms after a dirty and
    a clean flush, in turns (dirty, clean, clean, dirty), and device us
    from the profiler after a clean flush."""
    def dirty():
        scratch.zero_()

    def clean():
        scratch.sum(dtype=torch.int32)
    dst = torch.empty_like(lin)
    counts = torch.empty((lin.shape[0], K), device=lin.device)
    old = rk.OLD_DESIGN
    what = {"planned": (lambda: rk.launch(lin, K), "rowhist"),
            "load_only": (lambda: cs.k3_call(parts[1], lin, K, 1.0),
                          "rowhist"),
            "merge_only": (lambda: cs.k3_call(parts[2], lin, K, 1.0),
                           "rowhist"),
            "first_design_geometry": (lambda: rk.launch(lin, K, plan=old),
                                      "rowhist"),
            "first_design_geometry_load_only": (
                lambda: cs.k3_call(parts[1], lin, K, 1.0, old), "rowhist"),
            "copy of lin": (lambda: dst.copy_(lin), "Memcpy"),
            "fill of the counts": (lambda: counts.fill_(1.0), "Fill")}
    out = {w: {"dirty": [], "clean": []} for w in what}
    for name, flush in (("dirty", dirty), ("clean", clean), ("clean", clean),
                        ("dirty", dirty)):
        for w, (fn, _k) in what.items():
            out[w][name].append(cs.event_ms(fn, 30, flush, hold=True))
    for w, (fn, k) in what.items():
        out[w]["device_us_clean"] = prof_us(fn, clean, k)
    return out


def parent_kernel(path):
    """An earlier K3 source built and bound -> fn(lin, K) -> counts (its
    entry point: lin, srow, sp, R, P, K, g, out, rows_fast, stream)."""
    from halide_tpu_torch.ops import build
    text = Path(path).read_text()
    lib = build.load(build.source_key("rowhist_parent", text), Path(path))
    i, ll, vp = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.rowhist.argtypes = [vp, ll, ll, i, i, i, ctypes.c_float, vp, i, vp]
    lib.rowhist.restype = i

    def run(lin, k):
        R, P = lin.shape
        srow, sp = lin.stride()
        out = torch.empty((R, k), dtype=torch.float32, device=lin.device)
        rc = lib.rowhist(lin.data_ptr(), srow, sp, R, P, k, 1.0,
                         out.data_ptr(), int(srow == 1 and sp != 1),
                         torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent K3 failed: cudaError {rc}")
        return out
    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fit", help="a k3_sweep.json to fit the rule to")
    ap.add_argument("--out", default=str(ROOT / "build" / "k3_sweep.json"),
                    help="where to write the sweep's points")
    ap.add_argument("--parent-source",
                    help="an earlier csrc/rowhist_kernel.cu to time beside")
    args = ap.parse_args()
    from halide_tpu_torch.ops import rowhist_kernel as rk
    if args.fit:
        saved = json.loads(Path(args.fit).read_text())
        inputs, timed = {}, {}
        for n, v in saved["inputs"].items():
            # blocks an SM as the card's occupancy calculator gave them
            occ = {occupancy_key(dict(p["plan"],
                                      smem_bytes=p["smem_bytes"])):
                   p["resident"] for p in v["points"]
                   if p["build"] == "all_inflight"}
            inputs[n] = dict(shape=v["shape"], K=v["K"],
                             layout=tuple(v["layout"]),
                             resident=lambda p, occ=occ: occ.get(
                                 occupancy_key(p), rk.resident_model(
                                     p["threads"], p["smem_bytes"],
                                     p["unit"] // 4 * p["inflight"])))
            timed[n] = {key(p["plan"]): p["ms"] for p in v["points"]
                        if p["build"] == "all_inflight"}
        print(json.dumps({"fit": fit(inputs, timed)}), flush=True)
        return
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as cs
    from halide_tpu_torch.apps import hist
    from halide_tpu_torch.ops import build
    card = cs.card_line()
    print(card, flush=True)
    wide = [("ROWHIST_ALL_INFLIGHT", 1)]
    libs = {"all_inflight": cs.k3_build(wide),
            "match": cs.k3_build(wide, [(COUNT_ONE, MATCH)]),
            "regs64": cs.k3_build(wide, [(BOUNDS,
                                          "__launch_bounds__(1024, 1)")])}
    parts = {n: cs.k3_build([("ROWHIST_PART", n)]) for n in (1, 2)}
    parent = parent_kernel(args.parent_source) if args.parent_source \
        else None
    for k, secs in build.builds:
        print(json.dumps({"build": k, "s": secs,
                          "ptxas": build.ptxas.get(k, [])}), flush=True)
    app = hist.build(1536, 2560)
    app.bind(app.make_inputs(0))
    _out, calls = cs.capture(rk, "rowhist", app.realize)
    (lin_h, K_h, _scale), _kw = calls[0]
    assert K_h == K, K_h
    lins = dict(hist=lin_h, **cs.k3_inputs(lin_h, K), k1024=lin_h)
    res = rk.resident_of(libs["all_inflight"])
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    inputs, timed, report = {}, {}, {"card": card, "rule": dict(rk._RULE),
                                     "inputs": {}}
    for n, lin in lins.items():
        R, P = lin.shape
        k = K_OF.get(n, K)
        inputs[n] = dict(shape=(R, P), K=k, layout=rk.layout(lin),
                         resident=res)
        timed[n] = {}
        report["inputs"][n] = dict(
            shape=[R, P], K=k, stride=list(lin.stride()),
            base_mod_16=lin.data_ptr() % 16, layout=list(rk.layout(lin)),
            held_out=n in HELD_OUT,
            bound_ms=(lin.numel() + R * k) * 4 / cs.HBM_BYTES_PER_S * 1e3,
            points=[])
    want = {n: rk.rowhist_plain(lin, K_OF.get(n, K))
            for n, lin in lins.items()}

    def check(n, got, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want[n]):
            raise SystemExit(f"K3 {what} on {n} disagrees with its plain "
                             "version")

    def time_plan(n, force, build_name="all_inflight"):
        """Launch, check and time `force` on input n through a build ->
        ms (cached for the all-inflight build)."""
        lin, k, lib = lins[n], K_OF.get(n, K), libs[build_name]
        got = cs.k3_call(lib, lin, k, 1.0, force)
        plan = dict(rk.last_plan)
        pk = key(plan)
        if build_name == "all_inflight" and pk in timed[n]:
            return timed[n][pk]
        check(n, got, f"{build_name} at {plan}")
        ms = cs.event_ms(lambda: cs.k3_call(lib, lin, k, 1.0, plan), 30,
                         scratch.zero_, hold=True)
        if build_name == "all_inflight":
            timed[n][pk] = ms
        report["inputs"][n]["points"].append(
            dict(build=build_name, plan={f: plan[f] for f in rk.PLAN_FIELDS},
                 ms=ms, grid=plan["grid"], resident=plan["resident"],
                 smem_bytes=plan["smem_bytes"]))
        return ms

    def valid(n, force):
        try:
            rk.plan_rowhist(*inputs[n]["shape"], inputs[n]["K"],
                            inputs[n]["layout"], force, res)
        except ValueError:
            return False
        return True

    def sweep(names, forces, build_name="all_inflight"):
        for n in names:
            for force in forces:
                if valid(n, force):
                    time_plan(n, force, build_name)

    threads = (64, 96, 128, 192, 256, 384, 512, 1024)
    sweep(["hist", "odd_width"], [
        dict(rows=r, threads=t, inflight=L, copies=1, cluster=1)
        for r, t, L in itertools.product((1, 2, 4, 8), threads,
                                         (1, 2, 4, 8))])
    sweep(["hist"], [dict(rows=1, threads=t, inflight=L, copies=1,
                          cluster=2)
                     for t, L in itertools.product(threads, (1, 2, 4))])
    sweep(["offset", "k1024"], [
        dict(rows=r, threads=t, inflight=L, copies=1, cluster=1)
        for r, t, L in itertools.product((1, 2), threads, (1, 2, 4))])
    sweep(["rows_fast"], [dict(rows=r, threads=t, inflight=L, copies=1,
                               cluster=c)
                          for r, t, L, c in itertools.product(
                              (8, 16, 32), (256, 512, 1024), (1, 2, 4),
                              (1, 2, 4))])
    sweep(["long_rows", "cluster"], [
        dict(rows=r, threads=t, inflight=L, copies=1, cluster=c)
        for r, t, L, c in itertools.product(
            (1, 2), (256, 512, 1024), (1, 2, 4, 8), (1, 2, 4, 8))])
    sweep(["hist", "rows_fast", "long_rows", "cluster"],
          [dict(unit=u) for u in (4, 8, 16)])
    sweep(["hist"], [dict(unit=u, inflight=L) for u, L in itertools.product(
        (4, 8, 16), (1, 2, 4, 8))])
    sweep(["hist", "one_bin", "ramp"], [dict(copies=c) for c in (1, 2, 4, 8)])
    firsts = [dict(rk.OLD_DESIGN, inflight=L) for L in (1, 2, 4, 8)]
    sweep(lins, [None] + firsts)
    sweep(["hist", "one_bin", "ramp"], [dict(copies=c) for c in (1, 2)],
          "match")
    sweep(lins, [None, dict(unit=4), rk.OLD_DESIGN,
                 dict(rk.OLD_DESIGN, inflight=4)], "regs64")
    parent_ms = {}
    if parent is not None:
        for n, lin in lins.items():
            k = K_OF.get(n, K)
            check(n, parent(lin, k), "of the parent source")
            parent_ms[n] = cs.event_ms(lambda: parent(lin, k), 30,
                                       scratch.zero_, hold=True)
    for n, v in report["inputs"].items():
        pts = [p for p in v["points"] if p["build"] == "all_inflight"]
        best = min(pts, key=lambda p: p["ms"])
        rule = rk.plan_rowhist(*inputs[n]["shape"], inputs[n]["K"],
                               inputs[n]["layout"], None, res)
        v["parent_ms"] = parent_ms.get(n)
        print(json.dumps({
            "input": n, "shape": v["shape"], "K": v["K"], "card": card,
            "held_out": v["held_out"], "bound_ms": v["bound_ms"],
            "points": len(v["points"]), "fastest": best,
            "rule": {"plan": {f: rule[f] for f in rk.PLAN_FIELDS},
                     "ms": timed[n][key(rule)]},
            "first_design_geometry_ms": {
                L: timed[n][key(dict(rk.OLD_DESIGN, inflight=L))]
                for L in (1, 2, 4, 8)},
            "other_builds": [p for p in v["points"]
                             if p["build"] != "all_inflight"],
            "parent_ms": v["parent_ms"]}), flush=True)
    report["parts"] = parts_study(cs, rk, lin_h, scratch, parts)
    print(json.dumps({"parts": report["parts"], "card": card}), flush=True)
    report["fit"] = fit(inputs, timed, time_plan)
    print(json.dumps({"fit": report["fit"]}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report))
    print(f"{sum(len(v['points']) for v in report['inputs'].values())} "
          f"points -> {args.out}", flush=True)


if __name__ == "__main__":
    main()

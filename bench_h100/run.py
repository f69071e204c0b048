"""Run one cell of the benchmark once:

    python3 -m bench_h100.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the CUDA context, the input
ring made on the card from the seed, the app built at the cell's size, the
first realize, which plans and builds K1, and one warm-up pass over the
ring) is timed from the process's start. Then a closed loop of frames runs
for `--seconds`. With `--trace 1` a sub-window of frames is profiled after
it and the per-layer metrics are read. Last, the outputs of frames drawn
from the seed are held against the plain reference.

The last line of standard output is one JSON object; the numbers compared
are the last lines of standard error. A run that finds no CUDA device, or
finds JAX or the JAX package loaded, prints no result and exits with 1.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()      # set-up is timed from the process's start

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from . import stats  # noqa: E402
from .spec import Cell, find_cell, load_json  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# compared whole with each loaded module's top-level name: the port's
# name, halide_tpu_torch, begins with the JAX package's
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "halide_tpu"})


def set_cache_dirs(root: Path) -> None:
    """Fixed build and kernel cache directories inside the checkout (K1's
    own builds go to build/kernels there by the port's rule)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as ex:
        return f"nvidia-smi failed: {ex}"


def judge(cell: Cell, inputs, kept) -> tuple:
    """Each kept output against the plain reference on its ring slot's
    inputs -> ([(number, worst value, limit)], frames that failed)."""
    import torch
    check = cell.config["check"]
    ref, cmp = cell.reference(), cell.compare()
    worst, failed = {}, 0
    for _frame, slot, out in kept:
        with torch.no_grad():
            want = ref.reference(inputs.frame(slot), cell.config["args"])
        nums = cmp.numbers(out, want, check)
        del want
        if any(v > check["limits"][k] for k, v in nums.items()):
            failed += 1
        for k, v in nums.items():
            worst[k] = max(worst.get(k, v), v)
    return [(k, v, check["limits"][k]) for k, v in worst.items()], failed


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, units: dict, wrap=None) -> dict:
    """One run of `cell` on `device` -> {"result": the result line's
    object, "info": set-up and window details, "checks": [(name, value,
    limit)]}. `wrap`, where given, takes the stream and gives the call
    that stands for `Pipeline.realize` (the tests put faults under the
    timed path with it)."""
    now = time.perf_counter
    import torch
    setup = {"torch_import_s": now() - t_start}
    import halide_tpu_torch  # noqa: F401
    from .frames import Stream, build_app, make_inputs, run_window
    from .profile import profile_frames
    setup["port_import_s"] = now() - t_start - setup["torch_import_s"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t = now()
    if cuda:
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
    setup["cuda_context_s"] = now() - t
    t = now()
    inputs = make_inputs(cell, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    setup["input_ring_s"] = now() - t
    t = now()
    app = build_app(cell)
    setup["app_build_s"] = now() - t
    t = now()
    stream = Stream(app, inputs, dev)
    if wrap is not None:
        stream.realize = wrap(stream)
    stream.frame()
    setup["planning_realize_s"] = now() - t
    t = now()
    for _ in range(inputs.frames):
        stream.frame()
    setup["warmup_s"] = now() - t
    setup_s = now() - t_start

    peak_setup = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    window = run_window(stream, seconds, int(cell.traffic["check_frames"]),
                        random.Random(seed))
    peak_window = torch.cuda.max_memory_allocated(dev) if cuda else 0
    prof = None
    if trace and cuda:
        prof = profile_frames(stream)
    peak = max(peak_setup, peak_window,
               torch.cuda.max_memory_allocated(dev) if cuda else 0)
    n = len(window.spans)
    window_s = window.seconds
    # the mean frame time of each tenth of the window's frames: drift
    tenths = [sum(s.done - s.bind for s in part) * 1e3 / len(part)
              for part in (window.spans[k * n // 10:(k + 1) * n // 10]
                           for k in range(10)) if part]
    frame_ms = stats.frame_ms(window_s, n)

    metrics = {}
    if trace:
        rec = {"spans": window.spans, "frame_ms": frame_ms,
               "profile": prof, "work": cell.work, "setup": setup}
        for name in cell.metrics:
            v = cell.reader(name).read(rec)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
    else:
        lat = [(s.done - s.bind) * 1e3 for s in window.spans]
        for name, v in (("frame_ms", frame_ms),
                        ("frame_p95_ms", stats.p95(lat)),
                        ("setup_s", setup_s)):
            metrics[name] = {"value": v, "unit": units[name]}

    # the check: the program's state freed, its outputs and inputs kept
    kept = [(frame, slot, buf.data) for frame, slot, buf in window.kept]
    del stream, app, window
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, failed = judge(cell, inputs, kept)
    correct = bool(kept) and all(v <= lim for _k, v, lim in checks)

    device_rec = {"platform": "gpu" if cuda else dev.type,
                  "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                  "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": n, "failed": failed,
              "metrics": metrics, "device": device_rec}
    if prof is not None:
        device_rec["busy_s"] = prof.busy_us() * 1e-6
        device_rec["window_s"] = prof.wall_us * 1e-6
        result["breakdown"] = {"device_ops": prof.top_ops(),
                               "idle_gaps": prof.idle_by_host()}
    info = {"workload": cell.name, "seed": seed, "frames": n,
            "window_s": window_s,
            "ring_frames": inputs.frames, "setup": setup,
            "memory_peak_setup_bytes": int(peak_setup),
            "max_memory_allocated_window_bytes": int(peak_window),
            "checked_frames": [[f, s] for f, s, _o in kept],
            "window_tenths_ms": tenths}
    if prof is not None:
        info["profiled_frames"] = prof.frames
        info["k1_launches_per_frame"] = prof.k1_launched / prof.frames
        info["port_launches_per_frame"] = prof.port_launched / prof.frames
    for part in ("k1", "frame"):
        if part in cell.work:
            least, bound = stats.least_time_s(cell.work[part])
            info[f"{part}_least_ms"] = least * 1e3
            info[f"{part}_bound"] = bound
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return {"result": result, "info": info, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    benchmark = load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(benchmark, a.workload)
    units = {m["name"]: m["unit"]
             for m in benchmark["end_to_end"] + benchmark["per_layer"]}
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    out = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda:0",
                   T_START, units)
    found = forbidden_modules()
    if found:
        print("loaded in this process, and not allowed: " + ", ".join(found),
              file=sys.stderr)
        return 1
    card = card_line()
    out["info"]["card"] = card
    result = out["result"]
    checks = result.pop("checks")
    result["card"] = card
    result["checks"] = checks
    print(json.dumps(out["info"]), flush=True)
    for k, v, lim in out["checks"]:
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

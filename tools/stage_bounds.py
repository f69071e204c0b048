"""Each stage kernel of a benchmark cell against its bytes bound, on the
card.

    python tools/stage_bounds.py <cell> [<cell> ...] [--seed N]

For each cell (a workload of BENCHMARK.json): its app built at the cell's
size and its inputs made from the seed as the benchmark makes them
(bench_h100/frames.py), realized once; then every whole-array stage of
that realize is made again in order (`stage_kernel.stage_calls`), and each
stage the stage kernel takes is timed twice on the same arrays: its kernel
(`stage_kernel.launch`) and eval_torch's evaluation of the same stage (the
whole-array torch ops it replaces), each the median of CUDA-event times
of 10 calls with the card's L2 flushed before each, enqueued while the
card spins (device time, not the host's launch work). Its bytes bound is
what it reads of each input once plus its output once
(`StageSpec.bytes`) over 3.35 TB/s (bench_h100/peaks.py).

Prints the card's name and power limit, then one JSON line a stage (cell,
stage, key, extents, outputs a thread, kernel and eval_torch ms, bytes,
bound ms, the kernel's share of its bound in percent) and one a cell (the
sums); needs one CUDA card.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench_h100 import peaks  # noqa: E402
from bench_h100.frames import build_app, make_inputs  # noqa: E402
from bench_h100.spec import find_cell, load_json  # noqa: E402
from halide_tpu_torch.eval_torch import Ctx  # noqa: E402
from halide_tpu_torch.ops import stage_kernel as sk  # noqa: E402
from halide_tpu_torch.pipeline import (_evaluate_func,  # noqa: E402
                                       last_realize)

CALLS = 10
FLUSH_BYTES = 256 << 20          # five times the H100's 50 MiB L2


def event_ms(fn, flush) -> float:
    """Median device time of fn() over CALLS calls, L2 flushed before
    each: the card spins while the host enqueues them all, so each pair of
    events brackets the kernels alone, not the host's launch work."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)          # ~0.1 s of the card's cycles
    pairs = []
    for _ in range(CALLS):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def cell_stages(name: str, seed: int) -> None:
    cell = find_cell(load_json(ROOT / "BENCHMARK.json"), name)
    app = build_app(cell)
    inputs = make_inputs(cell, seed, torch.device("cuda"), frames=1)
    params = {p.name: p for p in app.inputs}
    for k, t in inputs.frame(0).items():
        params[k].set(t)
    app.pipeline.realize(app.output_sizes, device="cuda")
    torch.cuda.synchronize()
    values = last_realize(app.pipeline, "cuda")[4]
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    rows = []
    for f, box, before, spec, _out in sk.stage_calls(app.pipeline, "cuda"):
        if isinstance(spec, str):
            continue
        arrays = [before[tid].arrays[vi] for tid, vi in spec.slots]
        ctx0 = Ctx(0, {}, {}, before, values, "cuda")

        def whole_array():
            with sk.declining("timed against the kernel"):
                _evaluate_func(f, box, ctx0)
        kernel_ms = event_ms(lambda: sk.launch(spec, arrays,
                                               torch.device("cuda")), flush)
        torch_ms = event_ms(whole_array, flush)
        bound_ms = spec.bytes / peaks.HBM_BYTES_PER_S * 1e3
        row = {"cell": name, "stage": f.name, "key": spec.key,
               "extents": spec.extents, "vec": spec.vec,
               "kernel_ms": round(kernel_ms, 4),
               "eval_torch_ms": round(torch_ms, 4), "bytes": spec.bytes,
               "bound_ms": round(bound_ms, 4),
               "share_pct": round(100 * bound_ms / kernel_ms, 1)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    tot = {k: round(sum(r[k] for r in rows), 3)
           for k in ("kernel_ms", "eval_torch_ms", "bound_ms")}
    print(json.dumps({"cell": name, "stages": len(rows), **tot,
                      "share_pct": round(100 * tot["bound_ms"]
                                         / tot["kernel_ms"], 1)}),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args()
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    print(r.stdout.strip(), flush=True)
    for name in a.cells:
        cell_stages(name, a.seed)


if __name__ == "__main__":
    main()

"""The two readings each correctness limit is set from, for one cell, in
one process:

    python3 -m bench_h100.tools.readings --workload <cell> --seeds 12 --control-seeds 3

- the program's: for each seed, the input ring made as a run makes it, a
  frame realized on every slot of it through the same stream as the
  window, and each output held against the plain reference; the numbers of
  the seed are the worst over its frames;
- the control's: the plain reference put in the program's place and
  computed in the precision below the configuration's (`control_dtype`:
  bfloat16 for float32), held against the reference at the configuration's
  precision, on as many seeds.

Prints one JSON line a seed and side. The limits in each configuration's
`check` lie between the largest program reading and the smallest control
reading (PERF.md gives both).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from bench_h100.frames import Stream, build_app, make_inputs
from bench_h100.run import ROOT, judge, set_cache_dirs
from bench_h100.spec import Cell, find_cell, load_json

SEED0 = 4_000_000_000


def program_readings(cell: Cell, seed: int, device, app=None):
    """-> (numbers, app): a frame on every ring slot, each against the
    reference; the worst of each number."""
    dev = torch.device(device)
    inputs = make_inputs(cell, seed, dev)
    app = app or build_app(cell)
    stream = Stream(app, inputs, dev)
    kept = []
    for _ in range(inputs.frames):
        slot, _span = stream.frame()
        kept.append((slot, slot, stream.last.data))
    checks, _failed = judge(cell, inputs, kept)
    return {k: v for k, v, _lim in checks}, app


def control_readings(cell: Cell, seed: int, device, dtype) -> dict:
    """The reference in `dtype` in the program's place, on every slot."""
    inputs = make_inputs(cell, seed, torch.device(device))
    ref = cell.reference()
    kept = [(slot, slot, ref.reference(inputs.frame(slot),
                                       cell.config["args"], dtype))
            for slot in range(inputs.frames)]
    checks, _failed = judge(cell, inputs, kept)
    return {k: v for k, v, _lim in checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    a = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    cell = find_cell(load_json(ROOT / "BENCHMARK.json"), a.workload)
    dtype = getattr(torch, cell.config["check"]["control_dtype"])
    app = None
    for k in range(a.seeds):
        seed = SEED0 + k
        nums, app = program_readings(cell, seed, "cuda", app)
        print(json.dumps({"workload": cell.name, "side": "program",
                          "seed": seed, "numbers": nums}), flush=True)
    del app
    for k in range(a.control_seeds):
        seed = SEED0 + k
        nums = control_readings(cell, seed, "cuda", dtype)
        print(json.dumps({"workload": cell.name, "side": "control",
                          "control_dtype": str(dtype), "seed": seed,
                          "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Witness of a fault in torch's CPU `exp` (float32), apart from the port.

Each child process builds the argument of local_laplacian's remap exactly
as the app does, in numpy (fx = (idx - 256 k) / 256 over the 8 intensity
levels, -fx * fx / 2; idx from the gray level of `make_inputs(0)` at
512x128), runs one elementwise op to wake torch's thread pool, then calls
`torch.exp` twice on the same tensor and holds both calls against numpy's
exp in float64. Nothing of halide_tpu_torch or halide_tpu is imported.

    python tools/cpu_exp_witness.py [--procs 20] [--threads 8 1]

Per thread count it prints how many processes got a wrong first or second
call, and for each wrong call the worst error and the span of wrong
elements beside the size of one thread's share (numel / threads). Exit
code 0 either way: this is a record, not a test.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np


def remap_argument(width=512, height=128, levels=8, seed=0):
    rng = np.random.default_rng(seed)
    inp = rng.integers(0, 1 << 16, (3, height, width), np.uint16)
    f = np.float32
    gray = (f(0.299) * (inp[0] / f(65535)) + f(0.587) * (inp[1] / f(65535))
            + f(0.114) * (inp[2] / f(65535))).astype(f)
    idx = np.clip((gray * f(levels - 1) * f(256.0)).astype(np.int32), 0,
                  (levels - 1) * 256)
    k = np.arange(levels, dtype=np.int32)[:, None, None]
    fx = (idx[None] - 256 * k).astype(f) / f(256.0)
    return (-fx * fx / f(2.0)).astype(f)


def child(threads):
    import torch
    torch.set_num_threads(threads)
    x = torch.from_numpy(remap_argument())
    (x * 1.0).sum()                       # wake the thread pool
    ref = np.exp(x.double().numpy()).ravel()
    out = []
    for call in (torch.exp(x), torch.exp(x)):
        err = np.abs(call.double().numpy().ravel() - ref)
        bad = np.nonzero(err > 1e-6)[0]
        out.append({"wrong": int(bad.size), "max_abs_err": float(err.max()),
                    "span": [int(bad.min()), int(bad.max())]
                    if bad.size else None})
    print(json.dumps({"threads": threads, "numel": x.numel(),
                      "share": x.numel() // threads, "calls": out}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=20)
    ap.add_argument("--threads", type=int, nargs="+", default=[8, 1])
    ap.add_argument("--child", type=int)
    a = ap.parse_args()
    if a.child is not None:
        child(a.child)
        return
    for threads in a.threads:
        runs = [json.loads(subprocess.run(
            [sys.executable, __file__, "--child", str(threads)],
            capture_output=True, text=True, check=True).stdout)
            for _ in range(a.procs)]
        first = [r for r in runs if r["calls"][0]["wrong"]]
        second = [r for r in runs if r["calls"][1]["wrong"]]
        print(f"{threads} threads: first call wrong in {len(first)} of "
              f"{len(runs)} processes, second call wrong in {len(second)}")
        for r in first:
            c = r["calls"][0]
            print(f"  first call: {c['wrong']} wrong, max abs err "
                  f"{c['max_abs_err']!r}, span {c['span']} (one thread's "
                  f"share: {r['share']} of {r['numel']})")


if __name__ == "__main__":
    main()

"""Fit the autoscheduler's cost-model coefficients to the attached card
(the reference trains its cost model against measured runtimes:
src/autoschedulers/adams2019/DefaultCostModel.cpp:180 + retrain_cost_model.cpp;
this measures the three analytical terms directly and prints a
target.FITTED_COST row).

    python -m halide_tpu_torch.tools.fitcost [--device cpu] [--size WxH]

Measurements, each the median device time of calls queued while the card
is held busy (CUDA events bracket the kernels alone, not the host's launch
work; the host clock on the CPU):
  1. Device-memory rate: a triad o = b + 1.5 a in one torch call over
     64 MB streams (3 streams x 4 bytes -> bytes/s).
  2. f32 rate: a K-deep multiply-add chain acc = acc * c + v, v the input
     point bound once by a Let, as the body of a tiled one-stage group,
     which runs in the stencil-group kernel K1 (where an inlined Func runs
     under the tiled schedules the autoscheduler writes); the slope of
     (t_K2 - t_K1) over the 2 (K2 - K1) operations a point. The same
     chain realized whole-array is printed beside it for the record: there
     each operation of the chain is a torch call and a pass over memory,
     so its slope measures the memory rate, not arithmetic.
  3. ops_per_byte = the K1 rate over the memory rate (machine balance).
  4. strided_penalty: a DSL A/B of a pipeline whose consumer reads a
     producer at stride 2 on both x and y: fused (inline, dual-strided
     reads) against split (compute_root). Ratio of the realizes' device
     times.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def chain_pipeline(ht, k: int, data, tile=None):
    """out[x, y] = the k-deep chain acc = acc * c + v from acc = v, v the
    input point (a Let). With `tile`, the output is tiled: a one-stage
    group, K1's path."""
    from ..expr import Let, Variable
    x, y = ht.Var("x"), ht.Var("y")
    inp = ht.ImageParam(ht.Float(32), 2, "fc_chain_in")
    v = Variable("v", ht.Float(32))
    acc = v
    for _ in range(k):
        acc = acc * np.float32(1.0000001) + v
    out = ht.Func("fc_chain")
    out[x, y] = Let("v", inp[x, y], acc)
    if tile is not None:
        xo, yo, xi, yi = (ht.Var(n) for n in ("xo", "yo", "xi", "yi"))
        out.tile(x, y, xo, yo, xi, yi, tile[0], tile[1])
    inp.set(data)
    return ht.Pipeline(out)


def strided_pipeline(ht, split: bool, data):
    """A consumer reading a producer at stride 2 on x and y: fused
    (inline) or split (the producer compute_root)."""
    x, y = ht.Var("x"), ht.Var("y")
    inp = ht.ImageParam(ht.Float(32), 2, "fc_in")
    dec = ht.Func("fc_dec")
    dec[x, y] = inp[2 * x, 2 * y] * 0.5
    out = ht.Func("fc_out")
    out[x, y] = dec[x, y] + dec[x + 1, y]
    if split:
        dec.compute_root()
    inp.set(data)
    return ht.Pipeline(out)


def main(argv=None) -> int:
    import halide_tpu_torch as ht
    from ..ops import group_kernel
    from ..pipeline import resolve_device
    from ..target import get_host_target
    from .timer import device_ms

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu to measure the host (default: the card)")
    ap.add_argument("--size", default="4096x4096",
                    help="WxH of the chain and the strided pipeline")
    ap.add_argument("--mb", type=int, default=64,
                    help="MB a triad stream")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    W, H = (int(v) for v in args.size.split("x"))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"fitcost: device {name}", flush=True)

    # 1) triad: reads a, b, writes o
    n = args.mb * (1 << 20) // 4
    a = torch.arange(n, dtype=torch.float32, device=dev) * 1e-6
    b = torch.ones(n, dtype=torch.float32, device=dev)
    o = torch.empty_like(a)
    dt = device_ms(lambda: torch.add(b, a, alpha=1.5, out=o), dev)
    bw = 3.0 * n * 4 / (dt * 1e-3)
    print(f"fitcost: triad {dt:.4f} ms -> {bw / 1e9:.0f} GB/s", flush=True)

    # 2) the chain in K1 (a tiled one-stage group), and whole-array
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.random((H, W), np.float32)).to(dev)
    k_lo, k_hi = 16, 128

    def chain_ms(k, tile):
        p = chain_pipeline(ht, k, data, tile)
        launches = group_kernel.launches
        ms = device_ms(lambda: p.realize([W, H], device=dev), dev, 10)
        if tile is not None and dev.type == "cuda" \
                and group_kernel.launches == launches:
            raise RuntimeError("fitcost: the chain's group did not launch "
                               f"K1 ({dict(group_kernel.rejects)})")
        return ms
    t_lo, t_hi = chain_ms(k_lo, (256, 128)), chain_ms(k_hi, (256, 128))
    ops = 2.0 * W * H * (k_hi - k_lo) / max((t_hi - t_lo) * 1e-3, 1e-12)
    print(f"fitcost: K1 chain slope {t_lo:.4f} -> {t_hi:.4f} ms "
          f"-> {ops / 1e12:.2f} T f32 ops/s", flush=True)
    w_lo, w_hi = chain_ms(k_lo, None), chain_ms(k_hi, None)
    ops_w = 2.0 * W * H * (k_hi - k_lo) / max((w_hi - w_lo) * 1e-3, 1e-12)
    print(f"fitcost: whole-array chain slope {w_lo:.4f} -> {w_hi:.4f} ms "
          f"-> {ops_w / 1e12:.3f} T ops/s (a torch call a step: memory "
          "passes, not arithmetic; not used)", flush=True)
    ops_per_byte = ops / bw

    # 3) the dual-strided fused-read penalty through the DSL
    # dec is read at x + 1: two input columns past 2 W
    img = torch.from_numpy(rng.random((2 * H, 2 * W + 2),
                                      np.float32)).to(dev)
    fused = strided_pipeline(ht, False, img)
    split = strided_pipeline(ht, True, img)
    t_fused = device_ms(lambda: fused.realize([W, H], device=dev), dev)
    t_split = device_ms(lambda: split.realize([W, H], device=dev), dev)
    ratio = t_fused / max(t_split, 1e-9)
    print(f"fitcost: dual-strided fused {t_fused:.4f} ms vs split "
          f"{t_split:.4f} ms -> penalty {ratio:.2f}x", flush=True)

    gen = get_host_target().generation if dev.type == "cuda" else "cpu"
    print("fitcost: suggested target.FITTED_COST row:", flush=True)
    print(f'    "{gen}": {{"ops_per_byte": {ops_per_byte:.1f}, '
          f'"strided_penalty": {max(ratio, 1.0):.1f}, '
          f'"smem_budget": 227 * 1024}},', flush=True)
    print(f"FITCOST {gen} ops_per_byte={ops_per_byte:.2f} "
          f"strided_penalty={ratio:.2f} bw_gbps={bw / 1e9:.0f} "
          f"k1_tops={ops / 1e12:.2f} whole_array_tops={ops_w / 1e12:.3f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

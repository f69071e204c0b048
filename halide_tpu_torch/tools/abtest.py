"""A/B harness: a stencil group whose windows are double-buffered against
the same group single-buffered, the counterpart of the JAX package's
tools/abtest.py (the reference's async()/ring_buffer() latency hiding,
src/AsyncProducers.cpp, tutorial lesson_24).

The stencil-group kernel K1 plans a second window buffer where a block
walks consecutive sub-tiles (a plan that carries a member along its walk):
the next sub-tile's windows are copied by cp.async while the current one
computes. HALIDE_TPU_NO_PIPELINE=1 plans one buffer instead, as it turns
the JAX planner's double-buffered copies off. This tool realizes the same
app both ways and prints the kernel's device time and the frame time of
each (tools/timer.py), with the plan's window buffers.

    python -m halide_tpu_torch.tools.abtest [app] [--size WxH] [--device cpu]

The default app is linear_blur, whose band walk carries its store_root
blur_x (blur's default schedule has no group).
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def measure(app_name: str, kw: dict, dev):
    """-> (frame ms, kernel ms, the group's plan record) of one build of
    the app; the kernel's time is that of the main path's K1 launches
    alone, made again on the realize's inputs."""
    from ..apps import get
    from ..ops import group_kernel
    from .timer import device_ms, frame_ms

    app = get(app_name)(**kw)
    app.bind(app.make_inputs(0), dev)
    group_kernel.last_plan = None
    app.realize(dev)
    plan = group_kernel.last_plan
    frame = frame_ms(lambda: app.realize(dev), dev)
    calls = group_kernel.group_calls(app.pipeline, dev)

    def kernels():
        for p, inputs, mins, params, _r in calls:
            group_kernel.compute(p, inputs, mins, params, dev)
    return frame, device_ms(kernels, dev), plan


def main(argv=None) -> int:
    from ..pipeline import resolve_device
    ap = argparse.ArgumentParser()
    ap.add_argument("app", nargs="?", default="linear_blur")
    ap.add_argument("--size", default=None, help="WxH override")
    ap.add_argument("--device", default=None, help="cpu (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    kw = {}
    if args.size:
        w, h = (int(v) for v in args.size.split("x"))
        kw = dict(width=w, height=h)

    old = os.environ.pop("HALIDE_TPU_NO_PIPELINE", None)
    try:
        f2, k2, p2 = measure(args.app, kw, dev)
        os.environ["HALIDE_TPU_NO_PIPELINE"] = "1"
        f1, k1, p1 = measure(args.app, kw, dev)
    finally:
        os.environ.pop("HALIDE_TPU_NO_PIPELINE", None)
        if old is not None:
            os.environ["HALIDE_TPU_NO_PIPELINE"] = old

    def bufs(p):
        return p and (p["n_buf"], p["prefetch"], p["walk"])
    print(f"{args.app} on {dev}: double-buffered kernel {k2:.4f} ms, frame "
          f"{f2:.4f} ms (n_buf, prefetch, walk {bufs(p2)}) | "
          f"single-buffered kernel {k1:.4f} ms, frame {f1:.4f} ms "
          f"({bufs(p1)}) | kernel speedup {k1 / max(k2, 1e-9):.3f}x")
    return 0 if np.isfinite(k1 + k2) else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Measured tile-size search: time a menu of tile shapes on the card and
report the winner beside the autoscheduler's own pick (the reference
autotunes its schedules against real timings, src/autoschedulers/adams2019
retrain loop; here the model stays analytical and this tool closes the loop
per pipeline). The counterpart of the JAX package's tools/tilesearch.py.

    python -m halide_tpu_torch.tools.tilesearch [app] [--size WxH]
           [--tiles 256x128,2560x128,...] [--device cpu]

Each shape rebuilds the app at its default schedule, sets the output's
estimates to its sizes, applies the autoscheduler with the forced tile
(params={"tile": (tx, ty)}), checks the output against the app's golden
under the app's rule, and times the realize (tools/timer.py: CUDA events
after a warm-up, L2 flushed). Prints one line per shape with the group
kernel's plan (`group_kernel.last_plan`), then the winner.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def check(app, got, ref) -> bool:
    """got equals the golden under the app's rule: within tolerance *
    max(1, |ref|) + atol at all but `mismatch_frac` of the points."""
    err = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    tol = app.tolerance * np.maximum(1.0, np.abs(ref)) \
        + max(app.atol, 1e-12)
    return float((err > tol).mean()) <= max(app.mismatch_frac, 0.0)


def search(app_name: str, tiles, size=None, device=None, out=sys.stdout):
    """-> [(ms, label, plan record)] of the autoscheduler's pick ("auto")
    and each tile of `tiles` that realizes correctly, fastest first."""
    from ..apps import get
    from ..autoschedule import apply_autoscheduler
    from ..ops import group_kernel
    from ..pipeline import resolve_device
    from .timer import frame_ms

    dev = resolve_device(device)
    kw = dict(width=size[0], height=size[1]) if size else {}
    rows = []
    for label, tile in [("auto", None)] + [
            (f"{t[0]}x{t[1]}", t) for t in tiles]:
        app = get(app_name)(**kw)
        for out_f in app.pipeline.outputs:
            out_f.set_estimates([(0, int(s)) for s in app.output_sizes])
        res = apply_autoscheduler(
            app.pipeline, params={"tile": tile} if tile else {})
        data = app.make_inputs(0)
        app.bind(data, dev)
        group_kernel.last_plan = None
        got = app.realize(dev).to_numpy()
        plan = group_kernel.last_plan
        if not check(app, got, np.asarray(app.reference(**data))):
            print(f"{label}: CHECK FAILED (plan {plan})", file=out,
                  flush=True)
            continue
        ms = frame_ms(lambda: app.realize(dev), dev)
        rows.append((ms, label, plan))
        print(f"{label}: {ms:.4f} ms  schedule="
              f"{res['schedule_source'].splitlines()[:1]} plan={plan}",
              file=out, flush=True)
    rows.sort(key=lambda r: r[0])
    if rows:
        print(f"winner: {rows[0][1]} at {rows[0][0]:.4f} ms", file=out)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("app", nargs="?", default="blur")
    ap.add_argument("--size", default=None, help="WxH override")
    ap.add_argument("--tiles", default=None,
                    help="comma-separated WxH tile menu")
    ap.add_argument("--device", default=None, help="cpu (default: the card)")
    args = ap.parse_args(argv)
    size = tuple(int(v) for v in args.size.split("x")) if args.size else None
    tiles = [tuple(int(v) for v in t.split("x"))
             for t in args.tiles.split(",")] if args.tiles else []
    rows = search(args.app, tiles, size, args.device)
    return 0 if rows else 1


if __name__ == "__main__":
    raise SystemExit(main())

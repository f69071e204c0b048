"""RunGen: generic runner/benchmarker for any registered pipeline
(reference: tools/RunGen.h:685,1267 + RunGenMain.cpp:345-494), the
counterpart of the JAX package's tools/rungen.py.

Usage:
  python -m halide_tpu_torch.tools.rungen blur input=random:42 --output o.npy
  python -m halide_tpu_torch.tools.rungen blur --benchmarks=all \\
      --parsable_output
  python -m halide_tpu_torch.tools.rungen camera_pipe --describe
Input bindings: file.npy, random:SEED, zero:, or scalar literals.
`--device cpu` runs on the CPU (default: the card). `--benchmarks` times
the realize with the package's frame timer (tools/timer.py: CUDA events
after a warm-up, L2 flushed between calls).
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def _parse_binding(spec: str, imageparam, app, name):
    if spec.startswith("random:"):
        parts = spec.split(":")
        seed = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        data = app.make_inputs(seed=seed)
        return data[name]
    if spec.startswith("zero"):
        data = app.make_inputs(seed=0)
        return np.zeros_like(data[name])
    if spec.endswith(".npy"):
        return np.load(spec)
    try:
        return int(spec)
    except ValueError:
        try:
            return float(spec)
        except ValueError:
            raise SystemExit(f"cannot parse binding {name}={spec!r}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: rungen <app> [name=binding ...] [--describe] "
              "[--output F.npy] [--benchmarks=all] [--parsable_output] "
              "[--estimate_all] [--device cpu] [param=value ...]",
              file=sys.stderr)
        from ..apps import load_all
        print("apps: " + ", ".join(sorted(load_all())), file=sys.stderr)
        return 1
    from ..apps import get

    name = argv[0]
    bindings = {}
    build_params = {}
    describe = benchmark = parsable = estimate_all = False
    out_path = None
    device = None
    for a in argv[1:]:
        if a == "--describe":
            describe = True
        elif a.startswith("--benchmarks"):
            benchmark = True
        elif a == "--parsable_output":
            parsable = True
        elif a in ("--estimate_all", "--default_input_buffers"):
            estimate_all = True
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a == "--device":
            device = "__next__"
        elif device == "__next__":
            device = a
        elif a.startswith("--output="):
            out_path = a.split("=", 1)[1]
        elif a == "--output":
            out_path = "__next__"
        elif out_path == "__next__":
            out_path = a
        elif a.startswith("--"):
            print(f"ignoring flag {a}", file=sys.stderr)
        elif "=" in a:
            k, v = a.split("=", 1)
            bindings[k] = v
        else:
            print(f"unexpected arg {a!r}", file=sys.stderr)
            return 1
    # integer build params (width=, height=, ...) are GeneratorParams
    for k in list(bindings):
        if k in ("width", "height", "levels", "stencils", "radius", "batch",
                 "image", "classes"):
            build_params[k] = int(bindings.pop(k))
    builder = get(name)
    try:
        app = builder(**build_params)
    except TypeError:
        app = builder()

    if describe:
        meta = {
            "name": app.name,
            "inputs": [{"name": getattr(i, "name", "?"),
                        "kind": type(i).__name__} for i in app.inputs],
            "output_sizes": app.output_sizes,
            "megapixels": app.megapixels,
        }
        print(json.dumps(meta, indent=1))
        return 0

    data = app.make_inputs(seed=0)
    for i in app.inputs:
        nm = getattr(i, "name", None)
        if nm in bindings:
            data[nm] = _parse_binding(bindings[nm], i, app, nm)
    from ..pipeline import resolve_device
    dev = resolve_device(device)
    app.bind(data, dev)

    if benchmark:
        from .timer import frame_ms
        ms = frame_ms(lambda: app.realize(dev), dev)
        mps = app.megapixels / (ms * 1e-3)
        if parsable:
            print(json.dumps({"name": app.name, "ms": ms,
                              "mp_per_s": mps, "device": str(dev)}))
        else:
            print(f"{app.name}: {ms:.4f} ms ({mps:.1f} MP/s) on {dev}")
        return 0

    t0 = time.time()
    out = app.realize(dev)
    outs = out if isinstance(out, (list, tuple)) else [out]
    arrays = [o.to_numpy() for o in outs]
    dt = time.time() - t0
    if parsable:
        print(json.dumps({"name": app.name, "compile_run_s": dt,
                          "outputs": [list(a.shape) for a in arrays]}))
    else:
        print(f"{app.name}: realized {[a.shape for a in arrays]} "
              f"in {dt:.2f}s")
    if out_path and out_path != "__next__":
        np.save(out_path, arrays[0])
        print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

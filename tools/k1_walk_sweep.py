"""Walk-length sweep of the stencil-group kernel's band walk on the card.

For the first band-walk group of linear_blur (1536x2560x3 f32),
stencil_chain (1536x2560 u16, 32 stencils: the last group, as the others
span two tiles across) and camera_pipe (2560x1920, tile 2560x128), at the
canonical sizes: the kernel's device time as planned
(a walk of one sub-tile a block), with the band walk off (one sub-tile per
block) and, on the same build, walking 1, 2, 4, 8 and 16 sub-tiles a block
with one window buffer, and with two where the walking windows are staged
ahead by cp.async; each checked equal to the walk-off output. Also the time
of blur's and local_laplacian's groups, which do not walk.

    python tools/k1_walk_sweep.py

Needs one CUDA card; prints the card's name and power limit, then one JSON
line per group: {"app", "func", "grid", "planned": [walk, n_buf],
"ms": {"planned": t, "off": t, "<walk>x<n_buf>": t, ...}}. Times are
CUDA-event medians of 30 launches with L2 flushed between them, the card
held while the host enqueues (chip_smoke.event_ms).
"""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as cs
    from halide_tpu_torch.apps import (blur, camera_pipe, linear_blur,
                                       local_laplacian, stencil_chain)
    from halide_tpu_torch.ops import group_kernel as gk
    print(cs.card_line(), flush=True)
    makers = [lambda: blur.build(2560, 1536, tile=(256, 128)),
              lambda: linear_blur.build(1536, 2560),
              lambda: stencil_chain.build(1536, 2560, 32, kernel=True),
              lambda: camera_pipe.build(2560, 1920, kernel=True,
                                        tile=(2560, 128)),
              lambda: local_laplacian.build(1536, 2560)]

    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def time_of(plan, inputs, rmins):
        return cs.event_ms(lambda: gk.launch(plan, inputs, rmins), 30,
                           scratch.zero_, hold=True)

    for make in makers:
        app = make()
        app.bind(app.make_inputs(0))
        app.realize()
        calls = gk.group_calls(app.pipeline)
        walking = [c for c in calls if c[0].band_walk]
        plan, inputs, rmins, _params, _r = (walking or calls)[0]
        off = copy.copy(plan)
        off.band_walk = False
        want = gk.launch(off, inputs, rmins)
        ms = {"planned": time_of(plan, inputs, rmins),
              "off": time_of(off, inputs, rmins)}
        if plan.band_walk:
            for walk in (1, 2, 4, 8, 16):
                for n_buf in (1, 2) if plan.prefetch == "cp.async" else (1,):
                    q = copy.copy(plan)
                    q.walk, q.n_buf = walk, n_buf
                    if not torch.equal(gk.launch(q, inputs, rmins), want):
                        sys.exit(f"{app.name}: walk {walk}, {n_buf} "
                                 "buffers changes the values")
                    ms[f"{walk}x{n_buf}"] = time_of(q, inputs, rmins)
        rec = plan.record()
        print(json.dumps({"app": app.name, "func": rec["func"],
                          "grid": rec["grid"], "sub_tile": rec["sub_tile"],
                          "prefetch": plan.prefetch,
                          "planned": [rec["walk"], rec["n_buf"]],
                          "ms": ms}), flush=True)


if __name__ == "__main__":
    main()

"""stencil_chain: N chained 5x5 stencils, uint16 -- fusion-depth stress test
(reference: apps/stencil_chain/stencil_chain_generator.cpp:14-34).

Each 25-tap stencil factors exactly into a 5-tap row pass and a 5-tap column
pass in f32 (every intermediate is an integer below 2^24) with one wrap mod
2^16 at the stage's end, as in the JAX app. Two schedules, chosen by
`build()`'s arguments:
- the default: every stage computed at root, whole-array;
- `kernel=True`: groups of 8 consecutive stencils, each anchored at its last
  stage, tiled in 128-row bands of the output's width with `parallel()`
  rows and the group's other stages computed at the tiles: one
  stencil-group kernel launch per group. An anchor before the last spans
  the output's width plus the reach of the stencils after it (4 columns
  each), so it takes two tiles across, the second shifted inwards over
  almost all of the first (the JAX package's partitioned lowering computes
  the same strip), and is no band walk; the last anchor is one where it
  has at least 4 bands;
- `slide=<tx>`: the kernel branch with tiles `min(tx, width)` wide and the
  group's stages also `store_at` the anchor's row loop. The JAX package
  carries them along the tile row (sliding window); the port computes a
  store_at stage whole in every sub-tile, as the carry measured slower on
  the H100 (PERF.md).

Both tiled branches need a height that is a multiple of 128 and a width of
at least 128; elsewhere the default is taken, as in the JAX app.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

import halide_tpu_torch as hl

from . import App, register

GROUP = 8


@register("stencil_chain")
def build(width: int = 1536, height: int = 2560, stencils: int = 32,
          kernel: bool = False, slide: Optional[int] = None) -> App:
    x, y = hl.Var("x"), hl.Var("y")
    inp = hl.ImageParam(hl.UInt(16), 2, "input")

    stages = [hl.repeat_edge(inp)]
    rows = []
    for s in range(stencils):
        prev = stages[-1]
        row = hl.Func(f"row_{s}")
        er = hl.f32(0)
        for j in range(-2, 3):
            er = er + float(j + 3) * hl.f32(prev[x, y + j])
        row[x, y] = er
        f = hl.Func(f"stage_{s}")
        ec = hl.f32(0)
        for i in range(-2, 3):
            ec = ec + float(i + 3) * row[x + i, y]
        # exact wrap: ec / 65536 is a power-of-two scale, the floor of an
        # exact integer is exact, and the difference is below 2^16
        f[x, y] = hl.u16(ec - 65536.0 * hl.floor(ec * (1.0 / 65536.0)))
        row.compute_root()
        f.compute_root()
        rows.append(row)
        stages.append(f)

    output = hl.Func("chain_out")
    output[x, y] = stages[-1][x, y]

    if (kernel or slide) and height % 128 == 0 and width >= 128:
        anchors = [s for s in range(stencils)
                   if (s + 1) % GROUP == 0 or s == stencils - 1]
        prev_a = -1
        for ai, s_idx in enumerate(anchors):
            f = stages[1 + s_idx]
            xo, yo, xi2, yi2 = (hl.Var(f"xo{ai}"), hl.Var(f"yo{ai}"),
                                hl.Var(f"xi{ai}"), hl.Var(f"yi{ai}"))
            f.tile(x, y, xo, yo, xi2, yi2, min(slide or width, width), 128) \
             .vectorize(xi2).parallel(yo)
            for m in range(prev_a + 1, s_idx):
                stages[1 + m].compute_at(f, xo)
                rows[m].compute_at(f, xo)
                if slide:
                    stages[1 + m].store_at(f, yo)
                    rows[m].store_at(f, yo)
            rows[s_idx].compute_at(f, xo)
            if slide:
                rows[s_idx].store_at(f, yo)
            prev_a = s_idx

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"input": rng.integers(0, 1 << 16, (height, width), np.uint16)}

    def reference(input):
        # only the *input* is edge-clamped; intermediate stages are computed
        # over regions grown by the remaining stencil reach
        cur = np.pad(input, 2 * stencils, mode="edge")
        for s in range(stencils):
            H2, W2 = cur.shape[0] - 4, cur.shape[1] - 4
            acc = np.zeros((H2, W2), np.uint16)
            for i in range(-2, 3):
                for j in range(-2, 3):
                    w = np.uint16((i + 3) * (j + 3))
                    acc = acc + w * cur[2 + j:2 + j + H2, 2 + i:2 + i + W2]
            cur = acc
        return cur

    return App("stencil_chain", hl.Pipeline(output), [inp], make_inputs,
               reference, [width, height])

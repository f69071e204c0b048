"""max_filter: circular-footprint sliding max via log-slices
(reference: apps/max_filter/max_filter_generator.cpp:17-55)."""
from __future__ import annotations

import math

import numpy as np

import halide_tpu_torch as hl

from . import App, register


@register("max_filter")
def build(width: int = 1536, height: int = 2560, radius: int = 26) -> App:
    x, y, c, t = hl.Var("x"), hl.Var("y"), hl.Var("c"), hl.Var("t")
    inp = hl.ImageParam(hl.Float(32), 3, "input")

    slices = int(math.ceil(math.log(radius) / math.log(2))) + 1

    bounded = hl.repeat_edge(
        inp, [(0, width), (0, height), None])

    vert_log = hl.Func("vert_log")
    vert_log[x, y, c, t] = bounded[x, y, c]
    r = hl.RDom(-radius, height + radius, 1, slices - 1, "r")
    vert_log[x, r.x, c, r.y] = hl.max(
        vert_log[x, r.x, c, r.y - 1],
        vert_log[x, r.x + hl.clamp(1 << (r.y - 1), 0, radius * 2), c,
                 r.y - 1])

    # The JAX app's formulation, kept so that both packages build the same
    # pipeline: radius is a compile-time parameter, so the per-column
    # window height (filter_height) and its log-slice index
    # (slice_for_radius) are static tables folded at build time, and every
    # vert_log read has constant offsets (shifted slices and a max tree,
    # no data-dependent selects; the reference computes the same tables
    # in-pipeline, apps/max_filter/max_filter_generator.cpp:17-33).
    def fh(dxv):
        return sum(1 for dyv in range(0, radius + 1)
                   if dxv * dxv + dyv * dyv < (radius + 0.25) ** 2)

    def slice_for(tv):
        return int(math.floor(math.log(2 * tv + 1) / math.log(2)))

    output = hl.Func("max_out")
    terms = []
    for dxv in range(-radius, radius + 1):
        tv = min(max(fh(dxv), 0), radius + 1)
        sl = min(max(slice_for(tv), 0), slices)
        k2 = min(max(1 << sl, 0), 2 * radius)
        first = vert_log[x + dxv, y - tv, c, sl]
        second = vert_log[x + dxv, y + tv + 1 - k2, c, sl]
        terms.append(hl.max(first, second))
    e_out = terms[0]
    for tm in terms[1:]:
        e_out = hl.max(e_out, tm)
    output[x, y, c] = e_out

    vert_log.compute_root()

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"input": rng.random((3, height, width), np.float32)}

    def reference(input):
        a = input  # np[c, h, w]
        # vert_log over y in [-radius - extra, height + ...]: emulate with a
        # generous pad; reads clamp into [0, H)
        ylo, yhi = -(radius + 2), height + 3 * radius  # covers all reads
        ys = np.clip(np.arange(ylo, yhi), 0, height - 1)
        V = [a[:, ys, :]]     # slice 0 at y offset ylo
        for s in range(1, slices):
            k = min(max(1 << (s - 1), 0), radius * 2)
            prev = V[s - 1]
            cur = prev.copy()
            # update covers r.x in [-radius, height - 1 + ... extent H+radius)
            n = prev.shape[1]
            idx = np.minimum(np.arange(n) + k, n - 1)
            upd = np.maximum(prev, prev[:, idx, :])
            # r.x range is [-radius, height-1]; positions outside keep init
            lo = -radius - ylo
            hi = (height - 1) - ylo + 1
            cur[:, lo:hi, :] = upd[:, lo:hi, :]
            V.append(cur)
        V = np.stack(V, axis=0)   # [slice, c, ypos, w]

        fh = np.array([
            sum(1 for dyv in range(0, radius + 1)
                if dxv * dxv + dyv * dyv < (radius + 0.25) ** 2)
            for dxv in range(-radius, radius + 1)], dtype=np.int32)

        out = np.full((3, height, width), -np.inf, np.float32)
        xs = np.arange(width)
        for i, dxv in enumerate(range(-radius, radius + 1)):
            tv = int(np.clip(fh[i], 0, radius + 1))
            sl = int(np.clip(math.floor(math.log(2 * tv + 1) / math.log(2)),
                             0, slices))
            sl_c = min(sl, slices - 1)
            k2 = min(max(1 << sl, 0), 2 * radius)
            ypos1 = np.arange(height) - tv - ylo
            ypos2 = np.arange(height) + tv + 1 - k2 - ylo
            v1 = V[sl_c][:, ypos1, :]
            v2 = V[sl_c][:, ypos2, :]
            vmax = np.maximum(v1, v2)
            xcl = np.clip(xs + dxv, -radius, width + radius - 1)
            # x beyond [0, W) reads the repeat-edge'd input: vert_log's x dim
            # is only materialized where needed; accesses clamp to [0, W-1]
            xcl = np.clip(xcl, 0, width - 1)
            out = np.maximum(out, vmax[:, :, xcl])
        return out

    return App("max_filter", hl.Pipeline(output), [inp], make_inputs,
               reference, [width, height, 3],
               megapixels=width * height / 1e6, tolerance=0.0)

"""nl_means: non-local means denoise — 4D search-window reductions
(reference: apps/nl_means/nl_means_generator.cpp:13-35)."""
from __future__ import annotations

import numpy as np

import halide_tpu_torch as hl

from . import App, register


@register("nl_means")
def build(width: int = 1536, height: int = 2560, patch_size: int = 7,
          search_area: int = 7, sigma: float = 0.12) -> App:
    x, y, c = hl.Var("x"), hl.Var("y"), hl.Var("c")
    dx, dy = hl.Var("dx"), hl.Var("dy")
    inp = hl.ImageParam(hl.Float(32), 3, "input")

    inv_sigma_sq = -1.0 / (sigma * sigma * patch_size * patch_size)
    clamped = hl.repeat_edge(inp)

    dc = hl.Func("dc")
    dc[x, y, dx, dy, c] = hl.pow(
        clamped[x, y, c] - clamped[x + dx, y + dy, c], 2.0)

    channels = hl.RDom(0, 3, "channels")
    d = hl.Func("d")
    d[x, y, dx, dy] = hl.sum(dc[x, y, dx, dy, channels.x])

    patch_dom = hl.RDom(-(patch_size // 2), patch_size, "patch")
    blur_d_y = hl.Func("blur_d_y")
    blur_d_y[x, y, dx, dy] = hl.sum(d[x, y + patch_dom.x, dx, dy])
    blur_d = hl.Func("blur_d")
    blur_d[x, y, dx, dy] = hl.sum(blur_d_y[x + patch_dom.x, y, dx, dy])
    # stage the separable box sums (the reference schedules these at tiles,
    # nl_means_generator.cpp:65-80); fully inline, the composed reads would
    # carry 4 small offset vars into 4-D index-grid gathers
    d.compute_root()
    blur_d_y.compute_root()
    blur_d.compute_root()
    # The JAX app's schedule and its switch (HALIDE_TPU_NLM_KERNEL=0 opts
    # out): the three 4-D stages (x, y, dx, dy) fuse into one group per
    # (x, y) tile -- one launch of the stencil-group kernel K1, with d and
    # blur_d_y in shared memory, never in device memory
    import os
    if width % 256 == 0 and height % 64 == 0 and \
            os.environ.get("HALIDE_TPU_NLM_KERNEL", "1") != "0":
        xo, yo, xin, yin = (hl.Var("xo"), hl.Var("yo"),
                            hl.Var("xin"), hl.Var("yin"))
        blur_d.tile(x, y, xo, yo, xin, yin, 256, 64) \
              .vectorize(xin).parallel(yo)
        d.compute_at(blur_d, xo)
        blur_d_y.compute_at(blur_d, xo)

    w = hl.Func("w")
    w[x, y, dx, dy] = hl.fast_exp(blur_d[x, y, dx, dy] * inv_sigma_sq)

    cwa = hl.Func("clamped_with_alpha")
    cwa[x, y, c] = hl.mux(c, [clamped[x, y, 0], clamped[x, y, 1],
                              clamped[x, y, 2], hl.f32(1.0)])

    s_dom = hl.RDom(-(search_area // 2), search_area,
                    -(search_area // 2), search_area, "s_dom")
    nlm_sum = hl.Func("non_local_means_sum")
    nlm_sum[x, y, c] += w[x, y, s_dom.x, s_dom.y] \
        * cwa[x + s_dom.x, y + s_dom.y, c]
    # Unroll the 49-tap search accumulation (reference unrolls s_dom.x,
    # nl_means_generator.cpp:62): shifted reads folded one tap at a time
    # instead of a stacked 49x temporary
    nlm_sum.update().unroll(s_dom.x).unroll(s_dom.y)

    output = hl.Func("non_local_means")
    output[x, y, c] = hl.clamp(
        nlm_sum[x, y, c] / nlm_sum[x, y, 3], 0.0, 1.0)

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"input": rng.random((3, height, width), np.float32)}

    def reference(input):
        f = np.float32
        H, W = height, width
        hp = patch_size // 2
        hs = search_area // 2

        def rd(img, xq, yq):
            return img[..., np.clip(yq, 0, H - 1)[:, None],
                       np.clip(xq, 0, W - 1)[None, :]]

        xs = np.arange(-hp - hs, W + hp + hs)
        ys = np.arange(-hp - hs, H + hp + hs)
        base = rd(input, xs, ys)     # [c, Y, X] over padded coords
        o = hp + hs

        acc = np.zeros((4, H, W), f)
        cwa_r = np.concatenate([base, np.ones((1,) + base.shape[1:], f)])
        for sy in range(-hs, hs + 1):
            for sx in range(-hs, hs + 1):
                shifted = rd(input, xs + sx, ys + sy)
                dsq = ((base - shifted) ** 2).sum(axis=0)   # over padded
                # two-stage separable box blur, matching blur_d_y/blur_d
                # association order
                bly = np.zeros((H, dsq.shape[1]), f)
                for py in range(-hp, hp + 1):
                    bly += dsq[o + py:o + py + H, :]
                bl = np.zeros((H, W), f)
                for px in range(-hp, hp + 1):
                    bl += bly[:, o + px:o + px + W]
                wgt = np.exp(bl * f(inv_sigma_sq))
                acc += wgt[None] * cwa_r[:, o + sy:o + sy + H,
                                         o + sx:o + sx + W]
        out = acc[:3] / acc[3]
        return np.clip(out, 0.0, 1.0).astype(f)

    return App("nl_means", hl.Pipeline(output), [inp], make_inputs,
               reference, [width, height, 3],
               megapixels=width * height / 1e6, tolerance=1e-3, atol=1e-3)

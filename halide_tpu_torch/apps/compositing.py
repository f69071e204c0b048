"""compositing: Porter-Duff blending of 6 RGBA layers with a runtime
bytecode of blend ops — the "mini interpreter" RDom::where pattern
(reference: apps/compositing/compositing_generator.cpp:11-150)."""
from __future__ import annotations

import numpy as np

import halide_tpu_torch as hl

from . import App, register

NUM_LAYERS = 6
NUM_MODES = 5


def _scale(a, b):
    # fixed-point multiply by a u8 alpha (reference: scale() int path).
    # The rounding shifts stay in u32, as the JAX app's: values fit (a <=
    # 65025, c <= 16.6M < 2^31; the numpy golden uses the same u32
    # arithmetic)
    c = hl.widening_mul(a, hl.cast(a.dtype, b))
    half = hl.cast(c.dtype, 1 << 7)
    c = c + ((c + half) >> 8)
    c = (c + half) >> 8
    return hl.cast(a.dtype, c)


def _invert(e):
    return ~e


def _premultiply(t):
    return (hl.widening_mul(t[0], t[3]), hl.widening_mul(t[1], t[3]),
            hl.widening_mul(t[2], t[3]), t[3])


def _over(a, b):
    return tuple(
        [b[i] + _scale(a[i], _invert(b[3])) for i in range(3)]
        + [b[3] + _scale(a[3], _invert(b[3]))])


def _atop(a, b):
    return tuple(
        [_scale(b[i], a[3]) + _scale(a[i], _invert(b[3])) for i in range(3)]
        + [a[3]])


def _xor(a, b):
    return tuple(
        [_scale(b[i], _invert(a[3])) + _scale(a[i], _invert(b[3]))
         for i in range(3)]
        + [_scale(b[3], _invert(a[3])) + _scale(a[3], _invert(b[3]))])


def _in(a, b):
    return tuple([_scale(a[i], b[3]) for i in range(3)]
                 + [_scale(a[3], b[3])])


def _out(a, b):
    return tuple([_scale(a[i], _invert(b[3])) for i in range(3)]
                 + [_scale(a[3], _invert(b[3]))])


@register("compositing")
def build(width: int = 1536, height: int = 2560,
          kernel: bool = True) -> App:
    x, y, c = hl.Var("x"), hl.Var("y"), hl.Var("c")
    layers = [hl.ImageParam(hl.UInt(8), 3, f"layer_{i}")
              for i in range(NUM_LAYERS)]
    ops = hl.ImageParam(hl.Int(32), 1, "ops")

    def layer_tuple(i, idx_expr=None):
        lp = layers[i]
        return (lp[x, y, 0], lp[x, y, 1], lp[x, y, 2], lp[x, y, 3])

    r = hl.RDom(0, NUM_MODES, 0, NUM_LAYERS - 1, "rops")
    r.where(r[0] == ops[r[1]])

    blended = hl.Func("blended")
    blended[x, y] = _premultiply(layer_tuple(0))
    a = tuple(blended[x, y][i] for i in range(4))
    # layer_muxed(k) selects layer k+1 per rdom step
    bsrc = tuple(
        hl.mux(r[1], [layers[i][x, y, ch] for i in range(1, NUM_LAYERS)])
        for ch in range(4))
    b = _premultiply(bsrc)
    blends = [_over(a, b), _atop(a, b), _xor(a, b), _in(a, b), _out(a, b)]
    blended[x, y] = tuple(
        hl.mux(r[0], [bl[ch] for bl in blends]) for ch in range(4))

    output = hl.Func("comp_out")
    v = tuple(blended[x, y][i] for i in range(4))
    norm = [hl.saturating_cast(
        hl.UInt(8), hl.fast_integer_divide(v[i] + v[3] / 2, v[3]))
        for i in range(3)]
    output[x, y, c] = hl.mux(c, norm + [hl.u8(v[3])])
    output.bound(c, 0, 4)

    # schedule (reference: apps/compositing/compositing_generator.cpp:
    # 155-172): the output tiled 256x128 where the sizes divide, `blended`
    # computed at its x tiles, so that the blend interpreter runs as one
    # stencil-group kernel: `blended` is a tuple-valued member whose masked
    # 5x5 update chain is computed in the kernel. kernel=False computes it
    # whole-array.
    if kernel and width % 256 == 0 and height % 128 == 0:
        xo, yo, xi2, yi2 = (hl.Var("xo"), hl.Var("yo"),
                            hl.Var("xi2"), hl.Var("yi2"))
        output.tile(x, y, xo, yo, xi2, yi2, 256, 128) \
              .vectorize(xi2).parallel(yo)
        blended.compute_at(output, xo)

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        data = {f"layer_{i}": rng.integers(
            0, 256, (4, height, width), np.uint8)
            for i in range(NUM_LAYERS)}
        for i in range(NUM_LAYERS):
            data[f"layer_{i}"][3] = rng.integers(
                1, 256, (height, width), np.uint8)   # nonzero alpha
        data["ops"] = rng.integers(0, NUM_MODES, NUM_LAYERS - 1, np.int32)
        return data

    def reference(ops, **layers_np):
        u8, u16, u32 = np.uint8, np.uint16, np.uint32

        def scale_np(a, b):
            cc = a.astype(u32) * b.astype(u32)
            cc = cc + ((cc + (1 << 7)) >> 8)
            cc = (cc + (1 << 7)) >> 8
            return cc.astype(a.dtype)

        def inv(e):
            return (~e).astype(e.dtype)

        def prem(t):
            return [t[0].astype(u16) * t[3], t[1].astype(u16) * t[3],
                    t[2].astype(u16) * t[3], t[3]]

        def over(a, b):
            return [b[i] + scale_np(a[i], inv(b[3])) for i in range(3)] + \
                [b[3] + scale_np(a[3], inv(b[3]))]

        def atop(a, b):
            return [scale_np(b[i], a[3]) + scale_np(a[i], inv(b[3]))
                    for i in range(3)] + [a[3]]

        def xor_(a, b):
            return [scale_np(b[i], inv(a[3])) + scale_np(a[i], inv(b[3]))
                    for i in range(3)] + \
                [scale_np(b[3], inv(a[3])) + scale_np(a[3], inv(b[3]))]

        def in_(a, b):
            return [scale_np(a[i], b[3]) for i in range(3)] + \
                [scale_np(a[3], b[3])]

        def out_(a, b):
            return [scale_np(a[i], inv(b[3])) for i in range(3)] + \
                [scale_np(a[3], inv(b[3]))]

        modes = [over, atop, xor_, in_, out_]
        cur = prem([layers_np["layer_0"][ch] for ch in range(4)])
        for li in range(1, NUM_LAYERS):
            b = prem([layers_np[f"layer_{li}"][ch] for ch in range(4)])
            cur = modes[int(ops[li - 1])](cur, b)
        al = cur[3].astype(u32)
        res = []
        for i in range(3):
            num = cur[i].astype(u32) + (al // 2)
            q = np.where(al == 0, 0, num // np.maximum(al, 1))
            res.append(np.clip(q, 0, 255).astype(u8))
        res.append(cur[3].astype(u8) if cur[3].dtype != u8
                   else cur[3])
        return np.stack(res)

    return App("compositing", hl.Pipeline(output), layers + [ops],
               make_inputs, reference, [width, height, 4],
               megapixels=width * height / 1e6)

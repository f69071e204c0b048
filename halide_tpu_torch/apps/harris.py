"""harris: corner detector — gradients, products, 3x3 sums, response
(reference: apps/harris/harris_generator.cpp:22-61). The reference realizes
output over mins (3,3); here the output is shifted so a 0-based region maps
to the same interior pixels."""
from __future__ import annotations

import numpy as np

import halide_tpu_torch as hl

from . import App, register


def _sum3x3(f, x, y):
    e = None
    for j in (-1, 0, 1):
        for i in (-1, 0, 1):
            t = f[x + i, y + j]
            e = t if e is None else e + t
    return e


@register("harris")
def build(width: int = 1536, height: int = 2560) -> App:
    x, y = hl.Var("x"), hl.Var("y")
    inp = hl.ImageParam(hl.Float(32), 3, "input")

    gray = hl.Func("gray")
    gray[x, y] = (0.299 * inp[x, y, 0] + 0.587 * inp[x, y, 1]
                  + 0.114 * inp[x, y, 2])

    Iy = hl.Func("Iy")
    Iy[x, y] = (gray[x - 1, y - 1] * (-1.0 / 12) + gray[x - 1, y + 1] * (1.0 / 12)
                + gray[x, y - 1] * (-2.0 / 12) + gray[x, y + 1] * (2.0 / 12)
                + gray[x + 1, y - 1] * (-1.0 / 12) + gray[x + 1, y + 1] * (1.0 / 12))

    Ix = hl.Func("Ix")
    Ix[x, y] = (gray[x - 1, y - 1] * (-1.0 / 12) + gray[x + 1, y - 1] * (1.0 / 12)
                + gray[x - 1, y] * (-2.0 / 12) + gray[x + 1, y] * (2.0 / 12)
                + gray[x - 1, y + 1] * (-1.0 / 12) + gray[x + 1, y + 1] * (1.0 / 12))

    Ixx = hl.Func("Ixx")
    Ixx[x, y] = Ix[x, y] * Ix[x, y]
    Iyy = hl.Func("Iyy")
    Iyy[x, y] = Iy[x, y] * Iy[x, y]
    Ixy = hl.Func("Ixy")
    Ixy[x, y] = Ix[x, y] * Iy[x, y]

    Sxx = hl.Func("Sxx")
    Sxx[x, y] = _sum3x3(Ixx, x, y)
    Syy = hl.Func("Syy")
    Syy[x, y] = _sum3x3(Iyy, x, y)
    Sxy = hl.Func("Sxy")
    Sxy[x, y] = _sum3x3(Ixy, x, y)

    det = hl.Func("det")
    det[x, y] = Sxx[x, y] * Syy[x, y] - Sxy[x, y] * Sxy[x, y]
    trace = hl.Func("trace")
    trace[x, y] = Sxx[x, y] + Syy[x, y]

    resp = hl.Func("resp")
    resp[x, y] = det[x, y] - 0.04 * trace[x, y] * trace[x, y]

    # shift: output(x, y) == response at interior pixel (x+3, y+3)
    output = hl.Func("harris_out")
    output[x, y] = resp[x + 3, y + 3]

    # scheduling parity with the reference CPU schedule: stage the wide
    # producers (XLA fuses further)
    for f in (gray, Ix, Iy):
        f.compute_root()
    Ix.compute_with(Iy, x)

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"input": rng.random((3, height, width), np.float32)}

    def reference(input):
        a = input.astype(np.float32)
        g = (np.float32(0.299) * a[0] + np.float32(0.587) * a[1]
             + np.float32(0.114) * a[2])
        f12 = np.float32(1.0 / 12)
        iy = (g[:-2, :-2] * -f12 + g[2:, :-2] * f12
              + g[:-2, 1:-1] * -2 * f12 + g[2:, 1:-1] * 2 * f12
              + g[:-2, 2:] * -f12 + g[2:, 2:] * f12)
        ix = (g[:-2, :-2] * -f12 + g[:-2, 2:] * f12
              + g[1:-1, :-2] * -2 * f12 + g[1:-1, 2:] * 2 * f12
              + g[2:, :-2] * -f12 + g[2:, 2:] * f12)

        def s33(m):
            out = np.zeros((m.shape[0] - 2, m.shape[1] - 2), np.float32)
            for j in range(3):
                for i in range(3):
                    out += m[j:j + m.shape[0] - 2, i:i + m.shape[1] - 2]
            return out

        sxx = s33(ix * ix)
        syy = s33(iy * iy)
        sxy = s33(ix * iy)
        det_r = sxx * syy - sxy * sxy
        tr = sxx + syy
        resp_r = det_r - np.float32(0.04) * tr * tr
        # resp_r[j, i] == response at pixel (i+2, j+2); output(x,y)=resp(x+3,y+3)
        return resp_r[1:1 + height - 6, 1:1 + width - 6]

    return App("harris", hl.Pipeline(output), [inp], make_inputs, reference,
               [width - 6, height - 6], tolerance=3e-3)

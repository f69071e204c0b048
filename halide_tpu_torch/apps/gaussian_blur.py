"""gaussian_blur: separable gaussian with normalized kernel
(reference: apps/gaussian_blur/gaussian_blur_generator.cpp:19-41
direct_gaussian_blur)."""
from __future__ import annotations

import math

import numpy as np

import halide_tpu_torch as hl

from . import App, register


@register("gaussian_blur")
def build(width: int = 1536, height: int = 2560, sigma: float = 1.5,
          trunc: float = 3.0) -> App:
    x, y = hl.Var("x"), hl.Var("y")
    inp = hl.ImageParam(hl.Float(32), 2, "input")
    clamped = hl.repeat_edge(inp)

    kernel = hl.Func("kernel")
    kernel[x] = hl.exp(-(x * x) / (2.0 * sigma * sigma))
    kernel.compute_root()

    radius = int(math.ceil(trunc * sigma))
    r = hl.RDom(-radius, 2 * radius + 1)

    kernel_sum = hl.Func("kernel_sum")
    kernel_sum[()] = hl.sum(kernel[r.x])
    kernel_sum.compute_root()

    kernel_normalized = hl.Func("kernel_normalized")
    kernel_normalized[x] = kernel[x] / kernel_sum[()]
    kernel_normalized.compute_root()

    blur_y = hl.Func("blur_y")
    blur_y[x, y] = hl.sum(kernel_normalized[r.x] * clamped[x, y + r.x])
    blur_x = hl.Func("blur_x")
    blur_x[x, y] = hl.sum(kernel_normalized[r.x] * blur_y[x + r.x, y])
    blur_y.compute_root()

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"input": rng.random((height, width), np.float32)}

    def reference(input):
        k = np.exp(-(np.arange(-radius, radius + 1, dtype=np.float32) ** 2)
                   / np.float32(2 * sigma * sigma))
        k = (k / k.sum()).astype(np.float32)
        by = np.zeros((height, width + 2 * radius), np.float32)
        src = np.pad(input, ((radius, radius), (2 * radius, 2 * radius)),
                     mode="edge")
        for i, kv in enumerate(k):
            by += kv * src[i:i + height, radius:radius + width + 2 * radius]
        bx = np.zeros((height, width), np.float32)
        for i, kv in enumerate(k):
            bx += kv * by[:, i:i + width]
        return bx

    return App("gaussian_blur", hl.Pipeline(blur_x), [inp], make_inputs,
               reference, [width, height], tolerance=1e-4, atol=1e-5)

"""Normwise relative error of float outputs: the largest distance of any
value from the reference's over the reference's largest magnitude,
max |got - want| / max |want|, in float64. A value that is not finite in
either reads as infinitely far (a NaN would pass any limit)."""
import math

import torch


def numbers(got: torch.Tensor, want: torch.Tensor, check: dict) -> dict:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(f"output {tuple(got.shape)} {got.dtype}, reference "
                         f"{tuple(want.shape)} {want.dtype}")
    g, w = got.double(), want.double()
    scale = w.abs().max().item()
    err = (g - w).abs().max().item()
    if not (math.isfinite(err) and math.isfinite(scale)):
        return {"max_rel_err": math.inf}
    if scale == 0:
        return {"max_rel_err": 0.0 if err == 0 else math.inf}
    return {"max_rel_err": err / scale}

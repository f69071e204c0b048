"""Bit for bit: the number of output values that differ from the
reference's. Its limit is 0."""
import torch

from bench_h100.u16 import to_i32


def numbers(got: torch.Tensor, want: torch.Tensor, check: dict) -> dict:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(f"output {tuple(got.shape)} {got.dtype}, reference "
                         f"{tuple(want.shape)} {want.dtype}")
    return {"values_differing": int((to_i32(got) != to_i32(want)).sum()
                                    .item())}

"""Within `atol` steps of the output's integer type: the share of output
values further than that from the reference's (%), and the largest
distance of any value."""
import torch

from bench_h100.u16 import to_i32


def numbers(got: torch.Tensor, want: torch.Tensor, check: dict) -> dict:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(f"output {tuple(got.shape)} {got.dtype}, reference "
                         f"{tuple(want.shape)} {want.dtype}")
    d = (to_i32(got) - to_i32(want)).abs_()
    over = (d > check["atol"]).sum().item()
    return {"share_over_atol_pct": 100.0 * over / d.numel(),
            "max_abs_diff": int(d.max().item())}

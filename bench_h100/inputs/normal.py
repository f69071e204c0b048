"""Floats drawn from a normal distribution on the device, in one call for
every frame of the ring: {"kind": "normal", "dtype": ..., "mean": ...,
"std": ...}. A std of 0 draws nothing and gives the mean everywhere."""
import torch


def make(spec: dict, shape, generator: torch.Generator,
         device) -> torch.Tensor:
    dtype = getattr(torch, spec["dtype"])
    mean, std = float(spec.get("mean", 0.0)), float(spec["std"])
    if std == 0:
        return torch.full(tuple(shape), mean, dtype=dtype, device=device)
    t = torch.randn(tuple(shape), generator=generator, device=device,
                    dtype=dtype)
    return t.mul_(std).add_(mean)

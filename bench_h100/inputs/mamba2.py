"""A Mamba-2 mixer's per-head parameters as its published initialisation
draws them (Dao and Gu 2024; transformers' Mamba2Mixer), on the device in
one call: {"kind": "mamba2", "dtype": "float32", "param": "A_log" |
"dt_bias"}. A_log = log(A) with A uniform over [1, 16); dt_bias the
inverse softplus of dt, with dt log-uniform over [1e-3, 1e-1)."""
import math

import torch


def make(spec: dict, shape, generator: torch.Generator,
         device) -> torch.Tensor:
    dtype = getattr(torch, spec["dtype"])
    u = torch.rand(tuple(shape), generator=generator, device=device,
                   dtype=torch.float64)
    if spec["param"] == "A_log":
        return torch.log(1.0 + 15.0 * u).to(dtype)
    if spec["param"] == "dt_bias":
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(lo + (hi - lo) * u)
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    raise ValueError(f"input {spec['name']}: no Mamba-2 parameter "
                     f"{spec['param']!r}")

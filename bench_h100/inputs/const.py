"""A value written in the configuration, the same in every run:
{"kind": "const", "dtype": ..., "value": [[...], ...]}."""
import torch


def make(spec: dict, shape, generator: torch.Generator,
         device) -> torch.Tensor:
    t = torch.tensor(spec["value"], dtype=getattr(torch, spec["dtype"]),
                     device=device)
    if list(t.shape) != list(shape):
        raise ValueError(f"input {spec['name']}: value of shape "
                         f"{list(t.shape)}, configuration says {list(shape)}")
    return t

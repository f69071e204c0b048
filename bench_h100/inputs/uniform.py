"""Integers drawn uniformly from [low, high) on the device, in one call for
every frame of the ring: {"kind": "uniform", "dtype": ..., "low": 0,
"high": ...}."""
import torch


def make(spec: dict, shape, generator: torch.Generator,
         device) -> torch.Tensor:
    low, high = int(spec.get("low", 0)), int(spec["high"])
    if spec["dtype"] == "uint16":
        # torch draws no uint16: draw int16 shifted down by 2**15 and flip
        # the sign bit, which is the same 16 bits as the value shifted back
        t = torch.randint(low - 32768, high - 32768, tuple(shape),
                          generator=generator, device=device,
                          dtype=torch.int16)
        return (t ^ -32768).view(torch.uint16)
    return torch.randint(low, high, tuple(shape), generator=generator,
                         device=device, dtype=getattr(torch, spec["dtype"]))

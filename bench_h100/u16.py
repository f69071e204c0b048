"""uint16 on the card by way of int16 views: PyTorch keeps few operations
for uint16, so values go to int32 and back through the same 16 bits."""
import torch


def to_i32(t: torch.Tensor) -> torch.Tensor:
    """Any integer tensor as int32 values; uint16 read as unsigned."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t.to(torch.int32)


def from_i32(t: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 65536) as a uint16 tensor."""
    return t.to(torch.int16).view(torch.uint16)

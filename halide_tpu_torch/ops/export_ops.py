"""The port's kernels as `torch.library` custom ops, so that an exported
program (`torch.export`, generator.export_compiled) names them.

K1, K2 and K3 launch through ctypes on raw pointers, which export tracing
cannot see: traced as they are, an exported program would drop them. While
`exporting()` holds (generator.export_compiled sets it), the wrappers call
these ops instead, and the exported graph holds one call of
`halide_tpu_torch::group` / `::scan` / `::rowhist` per launch, each with a
fake (shape) implementation for the tracer. Their real implementations
call the same wrappers as realize: the kernel on a CUDA tensor, its plain
version on a CPU tensor, so an exported program counts its launches where
realize does.

A K1 call names its plan by key (`group_key`: the consumer's name and the
hash of the emitted source); `plans` maps the key to the plan, the
windows' realized mins and the params, filled where a realize plans the
group (while tracing, or when generator.load_compiled plans the
pipeline's text again). Realize itself launches through ctypes directly,
not through these ops.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from ..htypes import torch_dtype

_EXPORTING = [False]
# group key -> (plan, windows' realized mins, params)
plans: Dict[str, tuple] = {}


def exporting() -> bool:
    return _EXPORTING[0]


@contextlib.contextmanager
def export_mode():
    """While it holds, the kernel wrappers call the custom ops."""
    old = _EXPORTING[0]
    _EXPORTING[0] = True
    try:
        yield
    finally:
        _EXPORTING[0] = old


@contextlib.contextmanager
def host_constant():
    """Around the evaluation of a constant on the host (a scan's
    coefficient read to a Python float): while a program is exported, with
    the tracer's modes off, so that the value is a number and not a traced
    tensor."""
    if not _EXPORTING[0]:
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes(), torch._C.DisableTorchFunction():
        yield


def group_key(plan) -> str:
    return f"{plan.f.name}:{plan.symbol}"


@torch.library.custom_op("halide_tpu_torch::group", mutates_args=())
def group_op(inputs: List[torch.Tensor], key: str) -> torch.Tensor:
    """K1 on the plan registered under `key`."""
    from . import group_kernel
    if key not in plans:
        raise KeyError(f"group kernel {key!r} is not planned in this "
                       "process (generator.load_compiled plans it)")
    plan, real_mins, params = plans[key]
    return group_kernel.compute(plan, list(inputs), real_mins, params,
                                inputs[0].device)


@group_op.register_fake
def _group_fake(inputs, key):
    plan = plans[key][0]
    return torch.empty(tuple(reversed(plan.extents)),
                       dtype=torch_dtype(plan.out_type),
                       device=inputs[0].device)


@torch.library.custom_op("halide_tpu_torch::scan", mutates_args=())
def scan_op(b: torch.Tensor, init: torch.Tensor, axis: int,
            backward: bool, a_const: Optional[float],
            a: Optional[torch.Tensor]) -> torch.Tensor:
    """K2a (a_const) or K2b (a) into a new tensor like b."""
    from . import scan_kernel
    out = torch.empty_like(b, memory_format=torch.contiguous_format)
    return scan_kernel.linear_scan(out, b, init, axis, backward, a_const, a)


@scan_op.register_fake
def _scan_fake(b, init, axis, backward, a_const, a):
    return torch.empty_like(b, memory_format=torch.contiguous_format)


@torch.library.custom_op("halide_tpu_torch::rowhist", mutates_args=())
def rowhist_op(lin2d: torch.Tensor, K: int, scale: float) -> torch.Tensor:
    """K3: (R, P) int32 bins -> (R, K) f32 counts * scale."""
    from . import rowhist_kernel
    return rowhist_kernel.rowhist(lin2d, K, scale)


@rowhist_op.register_fake
def _rowhist_fake(lin2d, K, scale):
    return torch.empty((lin2d.shape[0], K), dtype=torch.float32,
                       device=lin2d.device)

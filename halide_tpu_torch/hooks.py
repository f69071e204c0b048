"""Per-process print/error handler table (the JAX package's `hooks`, on
tensors).

The reference routes runtime print/error through a per-call handler table
(JITUserContext, reference: src/runtime/HalideRuntime.h:178-196; wired in
Pipeline.cpp:818 and JITModule.cpp). Here the analogous hooks are
process-level: `set_custom_print` / `set_error_handler` install callables
that receive the formatted message. In the array model a `print()`
intrinsic fires once per REALIZATION (with a value summary), not once per
scalar loop iteration — there is no scalar loop.
"""
from __future__ import annotations

import sys
from typing import Callable, Optional

import numpy as np
import torch

_print_handler: Optional[Callable[[str], None]] = None
_error_handler: Optional[Callable[[str], None]] = None


def set_custom_print(fn: Optional[Callable[[str], None]]):
    """Install a print handler (None restores stdout). Returns the
    previous handler (reference: JITUserContext::custom_print)."""
    global _print_handler
    prev = _print_handler
    _print_handler = fn
    return prev


def set_error_handler(fn: Optional[Callable[[str], None]]):
    """Install an error handler (None restores raise-RuntimeError).
    Returns the previous handler (reference: halide_set_error_handler)."""
    global _error_handler
    prev = _error_handler
    _error_handler = fn
    return prev


def halide_print(msg: str) -> None:
    if _print_handler is not None:
        _print_handler(msg)
    else:
        sys.stdout.write(msg)
        sys.stdout.flush()


def halide_error(msg: str) -> None:
    if _error_handler is not None:
        _error_handler(msg)
    else:
        raise RuntimeError(msg)


def to_numpy(v) -> np.ndarray:
    """A tensor (read back from the card, a wait for it) or array-like ->
    numpy; bfloat16, which numpy lacks, as float32."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.detach().cpu().numpy()
    return np.asarray(v)


def format_value(v, limit: int = 8) -> str:
    a = to_numpy(v)
    if a.size == 1:
        return str(a.reshape(())[()])
    flat = a.reshape(-1)
    head = ", ".join(str(x) for x in flat[:limit])
    more = f", ...({a.size} values)" if a.size > limit else ""
    return f"[{head}{more}]"

"""The scan kernel (K2): y[i] = a * y[i-1] + b[i] along one axis of an f32
array, forward or backward, from an init row, in one pass.

It replaces `halide_tpu/ops/pallas_scan.py:linear_scan` for Hopper (sm_90a):
K2a is its constant-coefficient body (`_kernel_const`, a Python float `a`),
K2b its per-element body (`_kernel_general`, `a` an array like `b`). Both are
entry points of one CUDA source, `csrc/scan_kernel.cu`, built through
ops/build.py (nvcc -> plain-C `.so` -> ctypes).

- Bound: device-memory bytes (b read once, y written once, a read once for
  K2b).
- Design: the array is viewed as (G, N, M) with N the scan axis, through its
  strides (no transpose). A block takes 32 lines by a segment of 8 x `sub`
  elements of the scan axis (`sub_for`); its threads scan `sub`-element
  pieces from a zero carry
  into affine pairs (A, B), compose them, and take the carry into the
  segment by decoupled look-back over the blocks before it (block order by
  a ticket counter). Along a strided axis the lanes read consecutive m
  (coalesced); along the contiguous one the segments are staged through
  shared memory by 16-byte loads where the strides and alignment allow. y
  goes straight into the caller's span (the Func's buffer). The wrapper
  allocates the look-back storage (`torch.zeros` for the flags); the kernel
  allocates nothing.

Beside the kernel: `linear_scan_plain`, its plain PyTorch version -- the JAX
package's algorithm (Kogge-Stone shift-FMA rounds within blocks of 256 along
the scan axis, a carry between blocks, rounds whose decay is below 1e-12
dropped for K2a), vectorized over the other axes. `linear_scan` takes it
only for tensors that lie on the CPU; on CUDA tensors it launches the kernel
or raises. `launches` counts launches per body.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from . import build as _build

launches = {"const": 0, "general": 0}     # kernel launches on CUDA tensors

_BN = 256           # scan-axis block of the plain version (the JAX kernel's)
_EPS = 1e-12        # drop shift rounds whose decay underflows f32


def sub_for(const: bool, contiguous: bool) -> int:
    """Elements a thread scans: 32 for K2a along the contiguous axis (half
    the blocks and look-backs for the same bytes; measured faster there,
    and slower along a strided axis, PERF.md), else 16 (K2b's staged a and
    b at 32 would pass 48 KB of static shared memory)."""
    return 32 if const and contiguous else 16


def linear_scan_plain(b: torch.Tensor, init: torch.Tensor, axis: int,
                      backward: bool, a_const: Optional[float] = None,
                      a: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The scan of y[i] = a*y[i-1] + b[i] along `axis` of `b` (y[-1] is
    `init`, b's shape with the axis reduced to 1), as a new tensor. Exactly
    one of a_const (a float) and a (a tensor like b) is given."""
    shape = list(b.shape)
    shape[axis] = 1
    y0 = init.expand(shape).movedim(axis, 0)[0]
    bb = b.movedim(axis, 0)
    aa = a.expand(b.shape).movedim(axis, 0) if a is not None else None
    if backward:
        bb = bb.flip(0)
        aa = aa.flip(0) if aa is not None else None
    n = bb.shape[0]
    out = torch.empty(bb.shape, dtype=b.dtype, device=b.device)
    carry = y0
    for s in range(0, n, _BN):
        bn = min(_BN, n - s)
        y = bb[s:s + bn]
        if a_const is not None:
            k, dk = 1, float(a_const)
            while k < bn and abs(dk) > _EPS:
                shifted = torch.cat([torch.zeros_like(y[:k]), y[:bn - k]])
                y = y + dk * shifted
                k *= 2
                dk = dk * dk
            pw = np.power(np.float32(a_const),
                          np.arange(1, bn + 1, dtype=np.float32))
            pw = torch.from_numpy(pw).to(b.device).reshape(
                (bn,) + (1,) * (y.dim() - 1))
            y = y + pw * carry
        else:
            A = aa[s:s + bn]
            k = 1
            while k < bn:
                B_sh = torch.cat([torch.zeros_like(y[:k]), y[:bn - k]])
                A_sh = torch.cat([torch.ones_like(A[:k]), A[:bn - k]])
                y = y + A * B_sh
                A = A * A_sh
                k *= 2
            y = y + A * carry
        out[s:s + bn] = y
        carry = y[bn - 1]
    if backward:
        out = out.flip(0)
    return out.movedim(0, axis)


def linear_scan(out: torch.Tensor, b: torch.Tensor, init: torch.Tensor,
                axis: int, backward: bool, a_const: Optional[float] = None,
                a: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write the scan of y[i] = a*y[i-1] + b[i] along `axis` into `out` (a
    tensor of b's shape, any strides, typically a span of a Func's buffer)
    and return it. On the CPU through the plain version; on the card
    through the kernel (K2a with a_const, K2b with a)."""
    if out.device.type == "cpu":
        out.copy_(linear_scan_plain(b, init, axis, backward, a_const, a))
        return out
    return launch(out, b, init, axis, backward, a_const, a)


def _gnm(t: torch.Tensor, axis: int) -> torch.Tensor:
    """t as a (G, N, M) view with N the `axis`, without a copy where the
    strides allow one."""
    g = math.prod(t.shape[:axis])
    m = math.prod(t.shape[axis + 1:])
    try:
        return t.view(g, t.shape[axis], m)
    except RuntimeError:
        return t.contiguous().view(g, t.shape[axis], m)


_I64 = ctypes.c_longlong
_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points of a build of csrc/scan_kernel.cu."""
    tail = [_PTR, _I64, _I64, _PTR, _I64, _I64, _I64, _INT, _INT, _INT,
            _INT, _INT, _PTR, _PTR, _PTR]    # init, y, G N M, backward,
    #                                          sub, flags, pairs, stream
    lib.scan_const.argtypes = [_PTR, _I64, _I64, _I64, ctypes.c_float] + tail
    lib.scan_const.restype = _INT
    lib.scan_general.argtypes = [_PTR, _I64, _I64, _I64,
                                 _PTR, _I64, _I64, _I64] + tail
    lib.scan_general.restype = _INT
    lib.scan_storage.argtypes = [_INT, _INT, _INT, _INT,
                                 ctypes.POINTER(_I64), ctypes.POINTER(_I64)]
    lib.scan_storage.restype = None
    return lib


def call(lib: ctypes.CDLL, out, b, init, axis: int, backward: bool,
         a_const=None, a=None, stream=None, sub=None) -> int:
    """Call the entry point of `lib` for these tensors: (G, N, M) views
    through their strides, the result written into `out`, the look-back
    storage allocated here on out's device (the flags zeroed), `sub`
    elements a thread (`sub_for` where not given). Returns the entry
    point's code (cudaGetLastError() on the card)."""
    shape = list(out.shape)
    shape[axis] = 1
    try:
        y = out.view(math.prod(out.shape[:axis]), out.shape[axis],
                     math.prod(out.shape[axis + 1:]))
    except RuntimeError as ex:
        raise ValueError(f"scan kernel: out (strides {out.stride()}) has no "
                         f"(G, N, M) view along axis {axis}") from ex
    b3 = _gnm(b, axis)
    i3 = _gnm(init.expand(shape), axis)
    G, N, M = y.shape
    if sub is None:
        sub = sub_for(a is None, M == 1)
    nflags, npairs = _I64(), _I64()
    lib.scan_storage(G, N, M, sub, ctypes.byref(nflags),
                     ctypes.byref(npairs))
    flags = torch.zeros(nflags.value, dtype=torch.int32, device=out.device)
    pairs = torch.empty(npairs.value, dtype=torch.float32, device=out.device)
    tail = [i3.data_ptr(), i3.stride(0), i3.stride(2), y.data_ptr(),
            y.stride(0), y.stride(1), y.stride(2), G, N, M, int(backward),
            sub, flags.data_ptr(), pairs.data_ptr(), stream]
    if a is None:
        return lib.scan_const(b3.data_ptr(), b3.stride(0), b3.stride(1),
                              b3.stride(2), float(a_const), *tail)
    a3 = _gnm(a, axis)
    return lib.scan_general(a3.data_ptr(), a3.stride(0), a3.stride(1),
                            a3.stride(2), b3.data_ptr(), b3.stride(0),
                            b3.stride(1), b3.stride(2), *tail)


def launch(out: torch.Tensor, b: torch.Tensor, init: torch.Tensor, axis: int,
           backward: bool, a_const: Optional[float] = None,
           a: Optional[torch.Tensor] = None,
           sub: Optional[int] = None) -> torch.Tensor:
    """Launch K2a (a_const) or K2b (a) on CUDA tensors, writing into `out`
    (`sub` elements a thread; `sub_for` where not given). Raises on a
    tensor it does not take and on a build or launch error."""
    if (a_const is None) == (a is None):
        raise ValueError("give exactly one of a_const and a")
    named = [("out", out), ("b", b), ("init", init)] + \
        ([("a", a)] if a is not None else [])
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"scan kernel: {name} is not on the card")
        if t.dtype != torch.float32:
            raise ValueError(f"scan kernel: {name} is {t.dtype}, not f32")
        if t.device != out.device:
            raise ValueError(f"scan kernel: {name} is on {t.device}, out on "
                             f"{out.device}")
    if tuple(b.shape) != tuple(out.shape) or \
            (a is not None and tuple(a.shape) != tuple(out.shape)):
        raise ValueError("scan kernel: b (and a) must have out's shape")
    body = "const" if a is None else "general"
    rc = call(bind(_build.load_fixed("scan_kernel")), out, b, init, axis,
              backward, a_const, a,
              torch.cuda.current_stream(out.device).cuda_stream, sub)
    if rc != 0:
        raise RuntimeError(f"scan kernel ({body}) launch failed: "
                           f"cudaError {rc}")
    launches[body] += 1
    return out

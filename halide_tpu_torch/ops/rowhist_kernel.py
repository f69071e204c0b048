"""The row-histogram kernel (K3): counts[r, k] = #{p : lin[r, p] == k} for
an (R, P) int32 array, as f32 times a constant g; bins outside [0, K) drop.

It replaces `halide_tpu/ops/onehot_mxu.py:rowhist_blockdiag` for Hopper
(sm_90a). The CUDA source is `csrc/rowhist_kernel.cu`, built through
ops/build.py (nvcc -> plain-C `.so` -> ctypes).

- Bound: device-memory bytes (lin read once, the (R, K) counts written).
- Design: a block takes 8 rows and keeps 8 * K int32 counters in shared
  memory; its 256 threads stride over P and count with shared-memory
  atomicAdd, then write counts * g. Integer atomics commute, so the result
  is exact and deterministic. The TPU body's block-diagonal MXU one-hot
  products are not carried over.

Beside the kernel: `rowhist_plain`, its plain PyTorch version (an integer
`scatter_add_` of ones into (R, K + 1), the drop column last, cut off).
`rowhist` takes it only for tensors that lie on the CPU; on a CUDA tensor it
launches the kernel or raises. `launches` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build as _build

launches = 0                              # kernel launches on CUDA tensors

_MAX_K = 1536      # 8 rows * K int32 counters within 48 KB of shared memory


def rowhist_plain(lin2d: torch.Tensor, K: int,
                  scale: float = 1.0) -> torch.Tensor:
    """(R, P) int bins -> (R, K) f32 counts * scale; bins outside [0, K)
    drop."""
    lin = lin2d.to(torch.int64)
    lin = torch.where((lin < 0) | (lin >= K), K, lin)
    counts = torch.zeros((lin.shape[0], K + 1), dtype=torch.int32,
                         device=lin.device)
    counts.scatter_add_(1, lin, torch.ones_like(lin, dtype=torch.int32))
    return counts[:, :K].to(torch.float32) * scale


def rowhist(lin2d: torch.Tensor, K: int, scale: float = 1.0) -> torch.Tensor:
    """Row histograms of `lin2d` as f32 counts * scale: on the CPU through
    the plain version, on the card through the kernel."""
    if lin2d.device.type == "cpu":
        return rowhist_plain(lin2d, K, scale)
    return launch(lin2d, K, scale)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry point of a build of csrc/rowhist_kernel.cu."""
    lib.rowhist.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    lib.rowhist.restype = ctypes.c_int
    return lib


def call(lib: ctypes.CDLL, lin2d: torch.Tensor, K: int, scale: float,
         out: torch.Tensor, stream=None) -> int:
    """Call the entry point of `lib` for an (R, P) int32 lin (any strides)
    into the contiguous (R, K) f32 `out`. Returns the entry point's code
    (cudaGetLastError() on the card)."""
    R, P = lin2d.shape
    srow, sp = lin2d.stride()
    rows_fast = int(srow == 1 and sp != 1)
    return lib.rowhist(lin2d.data_ptr(), srow, sp, R, P, K, float(scale),
                       out.data_ptr(), rows_fast, stream)


def launch(lin2d: torch.Tensor, K: int, scale: float = 1.0) -> torch.Tensor:
    """Launch K3 on a CUDA int32 (R, P) tensor (any strides); the (R, K)
    f32 output is allocated here. Raises on a tensor it does not take and
    on a build or launch error."""
    global launches
    if lin2d.device.type != "cuda":
        raise ValueError("row-histogram kernel: lin is not on the card")
    if lin2d.dtype != torch.int32 or lin2d.dim() != 2:
        raise ValueError(f"row-histogram kernel: lin must be a 2-D int32 "
                         f"tensor, got {lin2d.dtype} {tuple(lin2d.shape)}")
    if not 0 < K <= _MAX_K:
        raise ValueError(f"row-histogram kernel: K={K} outside (0, {_MAX_K}]")
    out = torch.empty((lin2d.shape[0], K), dtype=torch.float32,
                      device=lin2d.device)
    rc = call(bind(_build.load_fixed("rowhist_kernel")), lin2d, K, scale, out,
              torch.cuda.current_stream(lin2d.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"row-histogram kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out

"""Contraction paths: the device time a frame of the library kernels that
the convolution and einsum paths call: cuDNN's convolutions with their
layout transforms, cuBLAS's or CUTLASS's GEMMs; every kernel that is
neither PyTorch's own, nor the port's, nor a copy or fill
(`bench_h100/kernels.py`; profiler)."""
from bench_h100.kernels import is_library


def read(rec):
    p = rec["profile"]
    if p is None:
        return None
    us = [e - s for name, s, e in p.kernels if is_library(name)]
    if not us:
        return None
    return sum(us) * 1e-3 / p.frames

"""Whole-array stages around the contractions: the device time a frame of
every kernel, copy and fill that is not a library's (`bench_h100/
kernels.py`): the zero pads, the folded batch norms and ReLUs, the
residual adds, the pools, the softmax, the copies in and out of the
graph (profiler)."""
from bench_h100.kernels import is_library


def read(rec):
    p = rec["profile"]
    if p is None:
        return None
    us = [e - s for name, s, e in p.kernels if not is_library(name)]
    if not us:
        return None
    return sum(us) * 1e-3 / p.frames

"""The library contractions' share of their roofline, cuBLAS's GEMMs
alone: the least time on the card of the configuration's frozen
contraction work (`work.<size>.contract`: every einsum's multiply-adds as
2 f32 operations, its operands and result once; the larger of the
operations over the f32 peak and the bytes over the memory's rate), over
the device time a frame of the library kernels (`bench_h100/kernels.py`),
the port's stage kernels (`stage_<key>`, which that file does not know)
left out (profiler)."""
import re

from bench_h100 import stats
from bench_h100.kernels import is_library

STAGE_KERNEL = re.compile(r"stage_[0-9a-f]{16}$")


def is_gemm(name: str) -> bool:
    return is_library(name) and not STAGE_KERNEL.match(name)


def read(rec):
    p, work = rec["profile"], rec["work"].get("contract")
    if p is None or work is None:
        return None
    us = sum(e - s for name, s, e in p.kernels if is_gemm(name))
    if us <= 0:
        return None
    least_s, _bound = stats.least_time_s(work)
    return stats.share_pct(least_s, us * 1e-6 / p.frames)

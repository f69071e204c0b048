"""The contractions' share of their roofline: the least time on the card
of the configuration's frozen contraction work (`work.<size>.contract`:
every convolution's and fc's multiply-adds as 2 f32 operations, their
inputs, weights and outputs once; the larger of the operations over the
f32 peak and the bytes over the memory's rate), over the library kernels'
device time a frame (profiler)."""
from bench_h100 import stats
from bench_h100.kernels import is_library


def read(rec):
    p, work = rec["profile"], rec["work"].get("contract")
    if p is None or work is None:
        return None
    us = sum(e - s for name, s, e in p.kernels if is_library(name))
    if us <= 0:
        return None
    least_s, _bound = stats.least_time_s(work)
    return stats.share_pct(least_s, us * 1e-6 / p.frames)

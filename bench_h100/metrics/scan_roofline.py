"""The scan kernel K2's share of its roofline: the least time on the card
of the configuration's frozen scan work (`work.<size>.scan`: each launch's
coefficients and terms read once and its states written once, a
multiply-add an element; the larger of the bytes over the memory's rate
and the operations over the f32 peak), over the `scan_segments` kernels'
device time a frame (profiler)."""
from bench_h100 import stats

K2_KERNELS = ("scan_segments",)


def read(rec):
    p, work = rec["profile"], rec["work"].get("scan")
    if p is None or work is None:
        return None
    us = sum(e - s for name, s, e in p.kernels
             if any(k in name for k in K2_KERNELS))
    if us <= 0:
        return None
    least_s, _bound = stats.least_time_s(work)
    return stats.share_pct(least_s, us * 1e-6 / p.frames)

"""K1's share of its roofline: the K1 group's least time on the card, from
the configuration's frozen work counts (the larger of its bytes over the
memory's rate and its operations over their peak), over K1's device time a
frame (profiler)."""
from bench_h100 import stats


def read(rec):
    p, work = rec["profile"], rec["work"].get("k1")
    if p is None or work is None:
        return None
    us = sum(e - s for name, s, e in p.kernels if p.is_k1(name))
    if us <= 0:
        return None
    least_s, _bound = stats.least_time_s(work)
    return stats.share_pct(least_s, us * 1e-6 / p.frames)

"""The whole frame's share of the chip's peak: the frame's least time, from
the configuration's frozen work counts (the app's inputs and output once,
every materialized stage's operations over its box), over the traced
run's mean frame time outside the profiled frames (host clock)."""
from bench_h100 import stats


def read(rec):
    work = rec["work"].get("frame")
    if work is None or not rec["spans"]:
        return None
    least_s, _bound = stats.least_time_s(work)
    return stats.share_pct(least_s, rec["frame_ms"] * 1e-3)

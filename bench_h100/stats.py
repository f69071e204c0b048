"""The benchmark's arithmetic: pure functions of host-clock times, profiler
intervals and frozen work counts, so that the CPU tests can hold them."""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple

from . import peaks


def frame_ms(window_s: float, frames: int) -> float:
    """The window's wall time over the frames completed in it."""
    if frames <= 0:
        raise ValueError("no frame completed in the window")
    return window_s * 1e3 / frames


def p95(values: Sequence[float]) -> float:
    """The 95th percentile of all values, by nearest rank: the smallest
    value that at least 95% of them do not exceed."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of [start, end) intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle gaps [end, next start) between the merged intervals."""
    out = []
    cur_e = None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def least_time_s(work: dict) -> Tuple[float, str]:
    """The least time the chip could take for `work` (bytes, f32_ops,
    int_ops): the largest of the bytes over the memory's rate and each kind
    of operation over its peak; -> (seconds, which bound)."""
    terms = {"bytes": work["bytes"] / peaks.HBM_BYTES_PER_S,
             "f32": work["f32_ops"] / peaks.F32_OPS_PER_S,
             "int32": work["int_ops"] / peaks.INT32_OPS_PER_S}
    bound = max(terms, key=terms.get)
    return terms[bound], bound


def share_pct(least_s: float, took_s: float) -> Optional[float]:
    """least / took as a percentage; None where nothing was timed."""
    if took_s <= 0:
        return None
    return 100.0 * least_s / took_s


"""Whole-array stages: the kernel launches a frame that the whole-array
stages make: CUDA launch calls (host events whose name holds
"LaunchKernel") that start inside one of the port's `ht.stage` ranges, in
the profiled frames (profiler)."""
import bisect


def read(rec):
    p = rec["profile"]
    if p is None:
        return None
    stages = sorted((s, e) for name, s, e in p.host if name == "ht.stage")
    if not stages:              # a port without spans
        return None
    starts = [s for s, _e in stages]
    n = 0
    for name, s, _e in p.host:
        if "LaunchKernel" in name:
            i = bisect.bisect_right(starts, s) - 1
            n += i >= 0 and s < stages[i][1]
    return n / p.frames

"""The device: one minus the union of kernel intervals over the profiled
frames' wall time (profiler; host clock for the wall time), in %."""


def read(rec):
    p = rec["profile"]
    if p is None or not p.kernels or p.wall_us <= 0:
        return None
    return 100.0 * (1.0 - p.busy_us() / p.wall_us)

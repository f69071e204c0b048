"""Whole-array stages: the device time a frame of every kernel, copy and
fill that is not one of the port's own kernels (profiler)."""


def read(rec):
    p = rec["profile"]
    if p is None:
        return None
    us = [e - s for name, s, e in p.kernels if not p.is_port(name)]
    if not us:
        return None
    return sum(us) * 1e-3 / p.frames

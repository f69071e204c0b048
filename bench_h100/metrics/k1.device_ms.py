"""Stencil-group kernel K1: the device time a frame of the kernels named
group_* (profiler)."""


def read(rec):
    p = rec["profile"]
    if p is None:
        return None
    us = [e - s for name, s, e in p.kernels if p.is_k1(name)]
    if not us:
        return None
    return sum(us) * 1e-3 / p.frames

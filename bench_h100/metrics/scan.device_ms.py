"""The scan kernel K2: the device time a frame of its `scan_segments`
kernels (K2a and K2b; granite_4_h_micro's inter-chunk state recurrence,
one K2b launch a Mamba-2 mixer) (profiler)."""
K2_KERNELS = ("scan_segments",)


def read(rec):
    p = rec["profile"]
    if p is None:
        return None
    us = [e - s for name, s, e in p.kernels
          if any(k in name for k in K2_KERNELS)]
    if not us:
        return None
    return sum(us) * 1e-3 / p.frames

"""The traced run's profiled frames: torch.profiler over a sub-window of
frames, kernel records by name and interval, and the host's events to say
what the host was doing in each idle gap. A copy of the port's chip check's
`breakdown` (chip_smoke.py) over a window of frames: a profile that holds
fewer records of the port's own kernels than the frames launched is
unsound, and is taken again, up to ATTEMPTS times."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from . import stats

ATTEMPTS = 3
# the frames a traced run profiles
FRAMES = 10
# the port's own kernels, by the names its builds give them: K1's emitted
# group kernels, the scan kernel K2 and the row-histogram kernel K3
PORT_KERNELS = ("group_", "scan_segments", "rowhist_blocks")
K1_KERNELS = ("group_",)
# the benchmark's own ranges (torch.profiler.record_function), which the
# profiler also puts on the device's timeline as annotations: not work
SPAN_PREFIX = "bench."
# a kernel's name in the breakdown: its first characters (a templated
# PyTorch kernel's name runs to a thousand)
NAME_CHARS = 160


def port_launches() -> int:
    """The port's counters of its kernels' launches, all together."""
    from halide_tpu_torch.ops import group_kernel as gk
    from halide_tpu_torch.ops import rowhist_kernel as rk
    from halide_tpu_torch.ops import scan_kernel as sk
    return gk.launches + rk.launches + sum(sk.launches.values())


def k1_launches() -> int:
    from halide_tpu_torch.ops import group_kernel as gk
    return gk.launches


@dataclass
class Profile:
    frames: int
    wall_us: float                              # first bind to last sync
    kernels: List[Tuple[str, float, float]]     # (name, start, end) in us
    host: List[Tuple[str, float, float]]        # the host's events
    port_launched: int                          # by the port's counters
    k1_launched: int

    def is_port(self, name: str) -> bool:
        return any(k in name for k in PORT_KERNELS)

    def is_k1(self, name: str) -> bool:
        return any(k in name for k in K1_KERNELS)

    def busy_us(self) -> float:
        return stats.union_length((s, e) for _n, s, e in self.kernels)

    def top_ops(self, n: int = 10) -> List[List]:
        by = {}
        for name, s, e in self.kernels:
            by[name] = by.get(name, 0.0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us * 1e-6] for name, us in top]

    def idle_by_host(self, n: int = 10) -> List[List]:
        """Idle time between kernels, summed by the innermost host event
        that holds each gap's middle ("host" where none does)."""
        names = [h[0] for h in self.host]
        hs = np.array([h[1] for h in self.host], dtype=np.float64)
        he = np.array([h[2] for h in self.host], dtype=np.float64)
        by = {}
        for s, e in stats.gaps((s, e) for _n, s, e in self.kernels):
            mid = (s + e) / 2
            holds = np.nonzero((hs <= mid) & (mid < he))[0]
            label = (names[holds[np.argmax(hs[holds])]] if holds.size
                     else "host")
            by[label] = by.get(label, 0.0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us * 1e-6] for name, us in top]


def profile_frames(stream, frames: int = FRAMES) -> Profile:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    for attempt in range(ATTEMPTS):
        n0, k0 = port_launches(), k1_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the profiler can lose the first kernel records of a session
            # (seen on the H100 once a process has run many launches):
            # eight short spins go first and are left out
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(frames):
                with record_function(SPAN_PREFIX + "frame"):
                    stream.frame()
            wall_us = (time.perf_counter() - t0) * 1e6
        launched, k1 = port_launches() - n0, k1_launches() - k0
        kernels, host = [], []
        for e in prof.events():
            s, t = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if "spin_kernel" not in e.name and \
                        not e.name.startswith(SPAN_PREFIX):
                    kernels.append((e.name, s, t))
            else:
                host.append((e.name, s, t))
        p = Profile(frames, wall_us, kernels, host, launched, k1)
        held = sum(1 for name, _s, _e in kernels if p.is_port(name))
        if held == launched:
            return p
        print(f"profile {attempt + 1} of {ATTEMPTS}: holds {held} records "
              f"of the port's kernels, the frames launched {launched}",
              flush=True)
    raise RuntimeError(f"{ATTEMPTS} profiles lost records of the port's "
                       "kernels")

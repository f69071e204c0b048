"""The tools' frame timer: what a caller waits for a call of `fn`, on the
card or on the CPU.

On the card: one warm-up call (plans, builds, fills the plan cache), then
`iters` calls, each after a write of 64 MB that evicts the card's 50 MB
L2 (a frame's input is not in L2 when a caller realizes it) and a
synchronize, bracketed by CUDA events on the current stream; the median.
On the CPU: the same calls on the host clock, without a flush.
`device_ms` times the card's work alone (fitcost).
"""
from __future__ import annotations

import statistics
import time

import torch

_FLUSH_BYTES = 64 << 20
_scratch = {}


def flush_l2(dev: torch.device) -> None:
    """Evict the card's L2 by writing a buffer larger than it."""
    buf = _scratch.get(dev)
    if buf is None:
        buf = _scratch[dev] = torch.empty(_FLUSH_BYTES, dtype=torch.uint8,
                                          device=dev)
    buf.zero_()


def frame_ms(fn, device, iters: int = 20) -> float:
    """Median milliseconds of fn() after a warm-up call (see the module
    docstring)."""
    dev = torch.device(device)
    fn()
    times = []
    for _ in range(iters):
        if dev.type == "cuda":
            flush_l2(dev)
            torch.cuda.synchronize(dev)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, dev: torch.device, iters: int = 20) -> float:
    """Median time of fn(): on the card each call between two CUDA events,
    all queued while the card spins (torch.cuda._sleep), so that the
    events bracket the device's work alone; on the CPU `frame_ms`."""
    if dev.type != "cuda":
        return frame_ms(fn, dev, iters)
    fn()
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(100_000_000)
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize(dev)
    return statistics.median(a.elapsed_time(b) for a, b in pairs)

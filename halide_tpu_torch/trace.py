"""Value tracing (reference: src/Tracing.cpp inject_tracing +
runtime/tracing.cpp packet stream + HL_TRACE_FILE).

`with tracing(pipeline, file=...) as t:` arms per-func trace flags
(`Func.trace_stores/loads/realizations`); each armed func emits
begin/end-realization events and a store event carrying the realized buffer
payload into the native packet writer (runtime/native/ht_runtime.cpp).
Event granularity is per realization (a whole-array stage or a group
kernel's output), not per scalar store, as in the JAX package.

The port is eager, so each event is a plain host call made when the stage
has been computed (the JAX package's ordered io_callbacks). A store's
payload is copied off the card only where the trace keeps payloads; the
members of a stencil-group kernel live in its shared memory and emit no
events, only the group's output does.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np

from .hooks import to_numpy
from .runtime import (EVENT_BEGIN_REALIZATION, EVENT_END_REALIZATION,
                      EVENT_PRINT, EVENT_STORE, TraceWriter)

_DTYPE_CODES = {"uint": 1, "int": 0, "float": 2, "bfloat": 3, "handle": 4}


class Trace:
    def __init__(self, file: Optional[str] = None, payloads: bool = True):
        self.writer = TraceWriter(file)
        self.events: List[tuple] = []    # (event, func_name, meta)
        self.payloads = payloads

    def record_realization(self, func, box, arrays) -> None:
        """begin, a store per value (where the func traces stores) and end
        events of one realization of `func` over `box`."""
        name = func.name
        mins, extents = box.mins(), box.extents()
        coords = []
        for m, e in zip(mins, extents):
            coords += [int(m), int(e)]
        self.events.append(("begin_realization", name,
                            tuple(zip(mins, extents))))
        self.writer.emit(EVENT_BEGIN_REALIZATION, name, 0, coords)
        if func._fschedule.trace_stores:
            t0 = func.output_type(0)
            code = _DTYPE_CODES.get(t0.code, 0) | (t0.bits << 8)
            for a in arrays:
                self.events.append(("store", name, tuple(a.shape)))
                payload = to_numpy(a).tobytes() if self.payloads else b""
                self.writer.emit(EVENT_STORE, name, code, coords, payload)
        self.events.append(("end_realization", name, ()))
        self.writer.emit(EVENT_END_REALIZATION, name, 0, coords)

    def emit_print(self, value) -> None:
        """A print event carrying the printed value (read to the host)."""
        v = np.asarray(to_numpy(value))
        self.events.append(("print", "", v))
        self.writer.emit(EVENT_PRINT, "print", 0, [], v.tobytes())

    def counts(self):
        out = {}
        for ev, name, _ in self.events:
            out[(ev, name)] = out.get((ev, name), 0) + 1
        return out

    def close(self):
        self.writer.close()


@contextlib.contextmanager
def tracing(pipeline, file: Optional[str] = None, payloads: bool = True):
    t = Trace(file, payloads)
    old = pipeline.trace
    pipeline.trace = t
    try:
        yield t
    finally:
        pipeline.trace = old
        t.close()

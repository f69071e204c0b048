"""Native host runtime bindings (ctypes over runtime/native/ht_runtime.cpp).

The host-side remainder of the reference's runtime (SURVEY.md §2.3): the
trace packet stream and the memoization cache's LRU. torch and the port's
CUDA kernels own device memory and execution. The source is built with g++
on first use through the kernels' route (`ops/build.load_host`: a
content-keyed library in `build/`), and a failed build or load raises: there
is no Python stand-in. The packet layout and the cache's behaviour are those
of the JAX package's runtime.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "native" / "ht_runtime.cpp"

_lib = None
_lib_lock = threading.Lock()

EVENT_LOAD = 0
EVENT_STORE = 1
EVENT_BEGIN_REALIZATION = 2
EVENT_END_REALIZATION = 3
EVENT_PRODUCE = 4
EVENT_CONSUME = 5
EVENT_PRINT = 6


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built on the first call."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from ..ops.build import load_host
        lib = load_host(_SRC)
        lib.ht_trace_open.argtypes = [ctypes.c_char_p]
        lib.ht_trace_open.restype = ctypes.c_int
        lib.ht_trace_emit.argtypes = [
            ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.c_uint32]
        lib.ht_trace_emit.restype = ctypes.c_int
        lib.ht_trace_packet_count.restype = ctypes.c_uint64
        lib.ht_trace_byte_count.restype = ctypes.c_uint64
        lib.ht_trace_close.restype = ctypes.c_int
        lib.ht_cache_set_size.argtypes = [ctypes.c_uint64]
        lib.ht_cache_store.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p,
            ctypes.c_uint64]
        lib.ht_cache_store.restype = ctypes.c_int
        lib.ht_cache_lookup.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p,
            ctypes.c_uint64]
        lib.ht_cache_lookup.restype = ctypes.c_int64
        lib.ht_cache_stats.argtypes = [
            ctypes.POINTER(ctypes.c_uint64)] * 5
        _lib = lib
        return lib


class MemoCache:
    """The native LRU result cache. Keys and values are bytes."""

    def __init__(self, max_bytes: int = 1 << 30):
        self._lib = get_lib()
        self._lib.ht_cache_set_size(max_bytes)

    def store(self, key: bytes, value: bytes) -> None:
        self._lib.ht_cache_store(key, len(key), value, len(value))

    def lookup(self, key: bytes) -> Optional[bytes]:
        n = self._lib.ht_cache_lookup(key, len(key), None, 0)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(max(n, 1))
        # the entry can be evicted between the size probe and the fill; a
        # negative or changed size on the second call is a miss
        n2 = self._lib.ht_cache_lookup(key, len(key), buf, n)
        if n2 < 0 or n2 != n:
            return None
        return buf.raw[:n]

    def stats(self) -> dict:
        vals = [ctypes.c_uint64() for _ in range(5)]
        self._lib.ht_cache_stats(*[ctypes.byref(v) for v in vals])
        return {"hits": vals[0].value, "misses": vals[1].value,
                "evictions": vals[2].value, "bytes": vals[3].value,
                "entries": vals[4].value}

    def clear(self) -> None:
        self._lib.ht_cache_clear()


class TraceWriter:
    """The native binary trace packet stream; with no path it only counts
    (`packets`, and the library's packet and byte counts)."""

    def __init__(self, path: Optional[str] = None):
        self._lib = get_lib()
        self.packets = 0
        if path:
            if self._lib.ht_trace_open(str(path).encode()) != 0:
                raise OSError(f"cannot open trace file {path}")

    def emit(self, event_code: int, name: str, dtype_code: int,
             coords, payload: bytes = b"") -> None:
        self.packets += 1
        coords = list(coords)[:8]
        arr = (ctypes.c_int32 * max(1, len(coords)))(*coords)
        self._lib.ht_trace_emit(event_code, name.encode(), dtype_code,
                                len(coords), arr, payload, len(payload))

    def close(self) -> None:
        self._lib.ht_trace_close()


_global_memo_cache: Optional[MemoCache] = None


def memo_cache() -> MemoCache:
    global _global_memo_cache
    if _global_memo_cache is None:
        _global_memo_cache = MemoCache()
    return _global_memo_cache

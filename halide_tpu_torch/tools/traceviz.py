"""Trace visualizer + dumper — the HalideTraceViz / HalideTraceDump analog
(reference: util/HalideTraceViz.cpp renders the store stream to video;
util/HalideTraceDump.cpp prints per-func statistics).

Reads the HTRC packet stream that the port's native writer
(runtime/native/ht_runtime.cpp `ht_trace_packet_header`) writes under
`halide_tpu_torch.trace.tracing(pipeline, file=...)`, and renders:

  * ``--dump``      per-func packet/byte/box statistics to stdout;
  * default         a self-contained HTML page: one heatmap panel per store
                    event (the realized buffer, normalized to grayscale,
                    zlib-PNG encoded inline) in event order, with a
                    realization timeline table.

The reference renders scalar-store videos because its loops store scalars;
here a store event is a whole realization (a whole-array stage, or a
stencil group's output: its members live in the kernel's shared memory and
emit no events), so the natural frame is one panel per realization.

Usage:
  python -m halide_tpu_torch.tools.traceviz trace.bin -o trace.html
  python -m halide_tpu_torch.tools.traceviz trace.bin --dump
"""
from __future__ import annotations

import base64
import struct
import sys
import zlib
from typing import List, Optional, Tuple

import numpy as np

_HDR = struct.Struct("<6I8i")
_MAGIC = 0x48545243
_EVENT_NAMES = {0: "load", 1: "store", 2: "begin_realization",
                3: "end_realization", 4: "produce", 5: "consume",
                6: "print"}


class Packet:
    __slots__ = ("event", "name", "dtype_code", "coords", "payload")

    def __init__(self, event, name, dtype_code, coords, payload):
        self.event = event
        self.name = name
        self.dtype_code = dtype_code
        self.coords = coords          # [(min, extent), ...]
        self.payload = payload

    @property
    def box(self) -> str:
        return " x ".join(f"[{m}, {m + e - 1}]" for m, e in self.coords)


def read_packets(path: str) -> List[Packet]:
    out = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off + _HDR.size <= len(data):
        vals = _HDR.unpack_from(data, off)
        magic, event, name_len, payload_len, dtype_code, dims = vals[:6]
        if magic != _MAGIC:
            raise ValueError(f"bad trace magic at offset {off}: {magic:#x}")
        # `dims` counts flat int32 slots; stores interleave (min, extent)
        coords_flat = vals[6:6 + min(dims, 8)]
        coords = [(coords_flat[i], coords_flat[i + 1])
                  for i in range(0, len(coords_flat) - 1, 2)]
        off += _HDR.size
        name = data[off:off + name_len].decode()
        off += name_len
        payload = data[off:off + payload_len]
        off += payload_len
        out.append(Packet(event, name, dtype_code, coords, payload))
    return out


def _payload_dtype(dtype_code: int) -> Optional[np.dtype]:
    code, bits = dtype_code & 0xFF, dtype_code >> 8
    table = {(0, 8): np.int8, (0, 16): np.int16, (0, 32): np.int32,
             (0, 64): np.int64,
             (1, 1): np.bool_, (1, 8): np.uint8, (1, 16): np.uint16,
             (1, 32): np.uint32, (1, 64): np.uint64,
             (2, 16): np.float16, (2, 32): np.float32, (2, 64): np.float64}
    np_t = table.get((code, bits))
    return np.dtype(np_t) if np_t is not None else None


def decode_store(p: Packet) -> Optional[np.ndarray]:
    """Payload bytes -> ndarray shaped by the coords box (numpy order)."""
    if not p.payload or not p.coords:
        return None
    shape = tuple(e for _m, e in reversed(p.coords))  # minor dim last
    n = int(np.prod(shape))
    if p.dtype_code == (3 | (16 << 8)):
        # bfloat16 (code 3): the port's writer stores it widened to f32
        # (numpy has no bfloat16); 2-byte items are the high halves of
        # f32s
        if n * 4 == len(p.payload):
            return np.frombuffer(p.payload, np.float32).reshape(shape)
        if n * 2 == len(p.payload):
            bits = np.frombuffer(p.payload, np.uint16).astype(np.uint32)
            return (bits << 16).view(np.float32).reshape(shape)
        return None
    dt = _payload_dtype(p.dtype_code)
    if dt is None:
        return None
    if dt == np.bool_:
        dt = np.dtype(np.uint8)
    if n * dt.itemsize != len(p.payload):
        return None
    return np.frombuffer(p.payload, dt).reshape(shape)


def _to_2d(a: np.ndarray) -> np.ndarray:
    """Project >2-D realizations for display: tile outer dims vertically."""
    a = np.asarray(a)
    if a.ndim == 0:
        return a.reshape(1, 1)
    if a.ndim == 1:
        return a.reshape(1, -1)
    if a.ndim == 2:
        return a
    return a.reshape(-1, a.shape[-1])


def _png_gray(img_u8: np.ndarray) -> bytes:
    """Minimal zlib PNG encoder (8-bit grayscale), stdlib only."""
    h, w = img_u8.shape
    raw = b"".join(b"\x00" + img_u8[r].tobytes() for r in range(h))

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def render_store_png(p: Packet, max_px: int = 512) -> Optional[bytes]:
    arr = decode_store(p)
    if arr is None:
        return None
    a = _to_2d(arr).astype(np.float64)
    # downsample by striding so panels stay small
    sy = max(1, (a.shape[0] + max_px - 1) // max_px)
    sx = max(1, (a.shape[1] + max_px - 1) // max_px)
    a = a[::sy, ::sx]
    finite = np.isfinite(a)
    lo = a[finite].min() if finite.any() else 0.0
    hi = a[finite].max() if finite.any() else 1.0
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    img = np.zeros_like(a)
    np.subtract(a, lo, out=img, where=finite)
    img = np.clip(img * scale, 0, 255).astype(np.uint8)
    return _png_gray(img)


def dump(packets: List[Packet], out=None) -> None:
    """HalideTraceDump-style per-func statistics."""
    out = out if out is not None else sys.stdout
    stats = {}
    for p in packets:
        s = stats.setdefault(p.name, {"events": 0, "stores": 0,
                                      "bytes": 0, "boxes": set()})
        s["events"] += 1
        if p.event == 1:
            s["stores"] += 1
            s["bytes"] += len(p.payload)
            s["boxes"].add(p.box)
    out.write(f"{'func':24s} {'events':>7s} {'stores':>7s} "
              f"{'payload':>12s}  boxes\n")
    for name, s in sorted(stats.items()):
        boxes = "; ".join(sorted(s["boxes"])[:3]) or "-"
        out.write(f"{name:24s} {s['events']:7d} {s['stores']:7d} "
                  f"{s['bytes']:12d}  {boxes}\n")
    out.write(f"total packets: {len(packets)}\n")


_CSS = """
body { font-family: sans-serif; background: #151515; color: #ddd; }
.panel { display: inline-block; margin: 6px; vertical-align: top;
         background: #222; padding: 6px; border-radius: 4px; }
.panel img { image-rendering: pixelated; border: 1px solid #444; }
.panel .cap { font-size: 12px; margin-top: 4px; max-width: 260px; }
table { border-collapse: collapse; font-size: 13px; }
td, th { border: 1px solid #444; padding: 2px 8px; }
h1, h2 { font-weight: normal; }
"""


def render_html(packets: List[Packet],
                title: str = "halide_tpu_torch trace",
                max_panels: int = 256) -> str:
    rows = []
    panels = []
    shown = 0
    for i, p in enumerate(packets):
        ev = _EVENT_NAMES.get(p.event, str(p.event))
        rows.append(f"<tr><td>{i}</td><td>{ev}</td><td>{p.name}</td>"
                    f"<td>{p.box}</td><td>{len(p.payload)}</td></tr>")
        if p.event == 1 and shown < max_panels:
            png = render_store_png(p)
            if png is not None:
                b64 = base64.b64encode(png).decode()
                panels.append(
                    f'<div class="panel"><img src="data:image/png;base64,'
                    f'{b64}"/><div class="cap">#{i} store <b>{p.name}</b>'
                    f'<br>{p.box}</div></div>')
                shown += 1
    omitted = sum(1 for p in packets if p.event == 1) - shown
    omit_note = (f"<p>({omitted} further store panels omitted)</p>"
                 if omitted > 0 else "")
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{title}</title><style>{_CSS}</style></head><body>"
            f"<h1>{title}</h1><h2>store heatmaps (event order)</h2>"
            f"{''.join(panels)}{omit_note}"
            f"<h2>event timeline</h2><table><tr><th>#</th><th>event</th>"
            f"<th>func</th><th>box</th><th>payload bytes</th></tr>"
            f"{''.join(rows)}</table></body></html>")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    path = None
    out_path = None
    do_dump = False
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--dump":
            do_dump = True
        elif a in ("-o", "--output"):
            i += 1
            out_path = argv[i]
        elif a in ("-h", "--help"):
            print(__doc__)
            return 0
        else:
            path = a
        i += 1
    if path is None:
        print(__doc__)
        return 1
    packets = read_packets(path)
    if do_dump:
        dump(packets)
        return 0
    html = render_html(packets)
    out_path = out_path or (path + ".html")
    with open(out_path, "w") as f:
        f.write(html)
    print(f"wrote {out_path}: {len(packets)} packets")
    return 0


if __name__ == "__main__":
    sys.exit(main())

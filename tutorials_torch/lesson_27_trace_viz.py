"""Lesson 27: visualizing traces
(reference: util/HalideTraceViz.cpp, util/HalideTraceDump.cpp and the
figures in tutorial/figures/ which are rendered from traces).

Arm funcs with trace_stores(), run under tracing(file=...), and feed
the packet stream to the traceviz tool:

  python -m halide_tpu_torch.tools.traceviz /tmp/t.bin --dump  # statistics
  python -m halide_tpu_torch.tools.traceviz /tmp/t.bin -o t.html  # heatmaps
"""
import os
import tempfile

import numpy as np
import halide_tpu_torch as hl
from halide_tpu_torch.trace import tracing
from halide_tpu_torch.tools import traceviz


def main(device=None):
    x, y = hl.Var("x"), hl.Var("y")
    blur_x = hl.Func("l27_bx")
    blur_y = hl.Func("l27_by")
    img = hl.ImageParam(hl.Float(32), 2, "l27_in")
    rng = np.random.default_rng(27)
    img.set(rng.random((64, 96), np.float32))
    blur_x[x, y] = (img[hl.clamp(x - 1, 0, 95), y] + img[x, y]
                    + img[hl.clamp(x + 1, 0, 95), y]) / 3
    blur_y[x, y] = (blur_x[x, hl.clamp(y - 1, 0, 63)] + blur_x[x, y]
                    + blur_x[x, hl.clamp(y + 1, 0, 63)]) / 3
    blur_x.compute_root().trace_stores().trace_realizations()
    blur_y.trace_stores().trace_realizations()

    pipe = hl.Pipeline(blur_y)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.bin")
        with tracing(pipe, file=path):
            pipe.realize([96, 64], device=device).to_numpy()
        packets = traceviz.read_packets(path)
        stores = [p for p in packets if p.event == 1]
        assert {p.name for p in stores} == {"l27_bx", "l27_by"}
        # decode a store payload back to the realized array
        arr = traceviz.decode_store(stores[0])
        assert arr is not None and arr.shape == (64, 96)
        html_path = os.path.join(d, "t.html")
        traceviz.main([path, "-o", html_path])
        with open(html_path) as fh:
            html = fh.read()
        assert "l27_bx" in html and "data:image/png" in html
        print(f"lesson 27: {len(packets)} packets, "
              f"{len(stores)} store panels rendered")


if __name__ == "__main__":
    main()

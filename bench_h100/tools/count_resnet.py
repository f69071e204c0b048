"""Count the frozen work of the resnet_50 configuration at each of its
sizes and write it into the configuration's file (`work`):

    python3 -m bench_h100.tools.count_resnet [--write]

- `contract`: the library contractions, the 53 convolutions and fc.
  Operations: each one's multiply-adds as 2 f32 operations, from the
  block structure (the app's `_resnet_flops`: the tests hold the two
  equal). Bytes: each one's input (unpadded), weights and bias, and its
  output, each once.
- `frame`: the whole realize. Bytes: the image, every weight and the
  probabilities, each once. Operations: every stored stage's point
  operations over the box the bounds pass gives it, the convolutions'
  updates at each RDom point (`count_work.frame_ops`, from one realize on
  the card; the tests call `count` on the CPU at a small size).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from bench_h100.frames import Stream, build_app, make_inputs
from bench_h100.spec import HERE, Cell, load_json
from bench_h100.tools.count_work import frame_ops
from bench_h100.tools.resnet_config import dumps

F32_BYTES = 4


def contractions(layers, width: int, classes: int, image: int,
                 batch: int) -> list:
    """(multiply-adds, bytes) of every convolution and fc, in the app's
    order (models/resnet50.build)."""
    out = []

    def conv(ci, co, k, stride, w, h):
        w2, h2 = w // stride, h // stride
        macs = batch * w2 * h2 * co * ci * k * k
        nbytes = F32_BYTES * (batch * w * h * ci + ci * k * k * co + co
                              + batch * w2 * h2 * co)
        out.append((macs, nbytes))
        return w2, h2

    w, h = conv(3, width, 7, 2, image, image)
    w, h = w // 2, h // 2                       # the max pool
    ch = width
    for stage, nblocks in enumerate(layers):
        mid = width * 2 ** stage
        out_ch = mid * 4
        for blk in range(nblocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            conv(ch, mid, 1, 1, w, h)
            w2, h2 = conv(mid, mid, 3, stride, w, h)
            conv(mid, out_ch, 1, 1, w2, h2)
            if stride != 1 or ch != out_ch:
                conv(ch, out_ch, 1, stride, w, h)
            ch = out_ch
            w, h = w2, h2
    out.append((batch * ch * classes,
                F32_BYTES * (batch * ch + ch * classes + classes
                             + batch * classes)))
    return out


def contract_work(layers, width, classes, image, batch) -> dict:
    parts = contractions(layers, width, classes, image, batch)
    return {"bytes": sum(b for _m, b in parts),
            "f32_ops": 2 * sum(m for m, _b in parts),
            "int_ops": 0, "contractions": len(parts)}


def count(cell: Cell, device) -> dict:
    dev = torch.device(device)
    args = cell.config["args"]
    image, batch = cell.size
    inputs = make_inputs(cell, 0, dev, frames=1)
    app = build_app(cell)
    stream = Stream(app, inputs, dev)
    stream.frame()
    out = stream.last.data
    frame_in = sum(t[0].numel() * t.element_size()
                   for t in inputs.ring.values()) + sum(
        t.numel() * t.element_size() for t in inputs.fixed.values())
    f32, i = frame_ops(app.pipeline)
    return {"frame": {"bytes": int(frame_in + out.numel()
                                   * out.element_size()),
                      "f32_ops": f32, "int_ops": i},
            "contract": contract_work(args["layers"], args["width"],
                                      args["classes"], image, batch)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="write the count into the configuration's file")
    a = ap.parse_args(argv)
    path = HERE / "configs" / "resnet_50.json"
    config = load_json(path)
    work = {}
    for size_class, size in config["sizes"].items():
        cell = Cell(f"{config['name']}.{size_class}", 1, config,
                    {"size": size_class}, list(size), {})
        work[size_class] = count(cell, "cuda")
        print(json.dumps({"config": config["name"], "size": size_class,
                          "work": work[size_class]}), flush=True)
    if a.write:
        config["work_method"] = "bench_h100/tools/count_resnet.py"
        config["work"] = work
        path.write_text(dumps(config))
    return 0


if __name__ == "__main__":
    sys.exit(main())

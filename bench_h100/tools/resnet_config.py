"""Write the resnet_50 configuration (`configs/resnet_50.json`) for any
depth, width, class count and sizes:

    python3 -m bench_h100.tools.resnet_config [--layers 3,4,6,3]
        [--width 64] [--classes 1000] [--size batch128=224x128] [--out F]

Its inputs are the app's (models/resnet50.py), in the app's layouts: the
image a ring input (n, y, x, c) float32, and every weight a fixed input
drawn once from the run's seed, in the layouts of
`models/resnet50.random_weights` (convolution weights (ci, ky, kx, co);
bias, folded batch-norm scale and shift (co,); fc (ci, classes) and
(classes,)). The distributions are chosen so that the residual stream
stays bounded through the 16 blocks and the softmax is informative
(`assumed` gives each and its reason). The frozen work (`work`) is
`count_resnet.py`'s; a file rewritten at the same arguments and sizes
keeps it.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

from bench_h100.spec import HERE

SOURCE = ("https://github.com/halide/Halide/blob/main/apps/resnet_50/"
          "Resnet50Generator.cpp")
# each folded batch norm's scale (mean, std), by the convolution it
# follows: the block's inner two and the stem near 1; the block's last
# (c) small, as the zero-gamma initialisation of Goyal et al. 2017 sets
# and trained networks keep; the downsample's (ds) below 1, so that the
# stream neither grows nor dies at each stage's first block
SCALE = {"": (1.0, 0.1), "c": (0.2, 0.02), "ds": (0.7, 0.07)}
SHIFT_STD = 0.01
FC_STD = 0.06
CHECK = {
    "kind": "relative",
    "control_dtype": "bfloat16",
    "limits": {"max_rel_err": 5e-5},
    "readings": "lower (the program, 12 seeds, every ring slot): "
                "2.90e-6 to 4.69e-6; upper: the program with TF32 "
                "allowed (HT_PRECISION=default, 3 seeds) 9.23e-4 to "
                "1.50e-3, the reference in bfloat16 (3 seeds) 2.34e-2 to "
                "3.08e-2; the limit sits 10.7x above the program's largest "
                "and 18x below TF32's smallest; the reference's largest "
                "probability a row: median 0.072, at most 0.216 (3072 "
                "rows); logits' std across classes 1.72-2.43 (H100 80GB "
                "HBM3, 700 W)",
}
ASSUMED = {
    "deployment": "MLPerf Inference's ResNet-50 v1.5, offline scenario: "
                  "224x224 images in large batches, judged by throughput; "
                  "batch 128 a realize, one in flight",
    "image": "normal(0, 1) from the seed: an image after ImageNet's "
             "per-channel normalisation, mean 0 and std 1",
    "conv_w": "He-normal, std sqrt(2 / (ci k k)): the ReLU network's "
              "activations keep their scale from layer to layer",
    "conv_b": "0: a folded batch norm's shift carries the bias",
    "bn_scale": "normal(1, 0.1) after the stem and each block's a and b "
                "convolutions; normal(0.2, 0.02) after c, the block's "
                "last, as zero-gamma initialisation (Goyal et al. 2017) "
                "and trained networks keep the residual branch small; "
                "normal(0.7, 0.07) after the downsample: the stream's rms "
                "stays within 0.5-2 through the 16 blocks",
    "bn_shift": "normal(0, 0.01): small beside unit activations, so that "
                "the image and not the shifts moves the logits",
    "fc_w": "normal(0, 0.06): the reference's logits spread by a "
            "standard deviation of 1.7-2.4 across the 1000 classes, and "
            "a row's largest probability is 0.03-0.22, not one-hot",
    "fc_b": "0",
}


def _normal(name, shape, mean, std, ring=False) -> dict:
    spec = {"name": name, "kind": "normal", "dtype": "float32",
            "mean": mean, "std": std, "shape": shape}
    if ring:
        spec["ring"] = True
    return spec


def inputs(layers, width: int, classes: int) -> list:
    """The app's inputs, in its order: the image, four a convolution,
    fc's two."""
    out = [_normal("image", [["h", 0], ["w", 0], ["w", 0], 3], 0.0, 1.0,
                   ring=True)]

    def conv(name, ci, co, k, role=""):
        smean, sstd = SCALE[role]
        out.extend([
            _normal(f"{name}_w", [ci, k, k, co], 0.0,
                    math.sqrt(2.0 / (ci * k * k))),
            _normal(f"{name}_b", [co], 0.0, 0.0),
            _normal(f"{name}_s", [co], smean, sstd),
            _normal(f"{name}_o", [co], 0.0, SHIFT_STD)])

    conv("conv1", 3, width, 7)
    ch = width
    for stage, nblocks in enumerate(layers):
        mid = width * 2 ** stage
        out_ch = mid * 4
        for blk in range(nblocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            name = f"res{stage}_{blk}"
            conv(f"{name}_a", ch, mid, 1)
            conv(f"{name}_b", mid, mid, 3)
            conv(f"{name}_c", mid, out_ch, 1, "c")
            if stride != 1 or ch != out_ch:
                conv(f"{name}_ds", ch, out_ch, 1, "ds")
            ch = out_ch
    out.append(_normal("fc_w", [ch, classes], 0.0, FC_STD))
    out.append(_normal("fc_b", [classes], 0.0, 0.0))
    return out


def config(layers=(3, 4, 6, 3), width: int = 64, classes: int = 1000,
           sizes=None, name: str = "resnet_50") -> dict:
    """The configuration; `sizes` maps a size class to [image, batch]."""
    sizes = sizes or {"batch128": [224, 128]}
    return {
        "name": name,
        "source": SOURCE,
        "app": "resnet_50",
        "args": {"layers": list(layers), "width": width, "classes": classes},
        "size_args": ["image", "batch"],
        "sizes": {k: list(v) for k, v in sizes.items()},
        "precision": "float32",
        "inputs": inputs(layers, width, classes),
        "check": json.loads(json.dumps(CHECK)),
        "reduced": [],
        "assumed": dict(ASSUMED),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", default="3,4,6,3")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--size", action="append",
                    help="CLASS=IMAGExBATCH, e.g. batch128=224x128")
    ap.add_argument("--out", type=Path,
                    default=HERE / "configs" / "resnet_50.json")
    a = ap.parse_args(argv)
    sizes = None
    if a.size:
        sizes = {}
        for s in a.size:
            cls, dims = s.split("=")
            image, batch = dims.split("x")
            sizes[cls] = [int(image), int(batch)]
    cfg = config(tuple(int(v) for v in a.layers.split(",")), a.width,
                 a.classes, sizes)
    if a.out.is_file():
        old = json.loads(a.out.read_text())
        if (old.get("args"), old.get("sizes")) == (cfg["args"],
                                                    cfg["sizes"]):
            for k in ("work_method", "work", "work_card"):
                if k in old:
                    cfg[k] = old[k]
    a.out.write_text(dumps(cfg))
    return 0


def dumps(cfg: dict) -> str:
    """The configuration as JSON, two-space indented, one input a line."""
    specs = cfg["inputs"]
    text = json.dumps({**cfg, "inputs": []}, indent=2)
    lines = ",\n".join("    " + json.dumps(s) for s in specs)
    return text.replace('"inputs": []', '"inputs": [\n' + lines + "\n  ]",
                        1) + "\n"


if __name__ == "__main__":
    sys.exit(main())

"""Write the granite_4_h_micro configuration (`configs/granite_4_h_micro
.json`): Granite 4.0-H Micro at its published widths and depth,

    python3 -m bench_h100.tools.granite_config [--size prefill4k=4096x1]
        [--out F]

Its top level holds every key of the model's config.json as published
(ibm-granite/granite-4.0-h-micro), `args` the keys the app and the
reference read, and `inputs` the app's: the prompt's tokens (batch, seq)
int32, a ring input, then every weight in the app's layouts
(`GraniteParams.weight_shapes`), drawn once from the seed as `assumed`
says; the embedding table is a ring input of kind `shared` (one draw in
every slot), so that the ring counts the table each frame reads whole.
The frozen work (`work`) is `count_granite.py`'s; a file rewritten at
the same arguments and sizes keeps it.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

from bench_h100.spec import HERE

SOURCE = ("https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/"
          "main/config.json")
# the model's config.json, as published (the keys that give its shape)
PUBLISHED = {
    "attention_bias": False, "attention_multiplier": 0.015625,
    "embedding_multiplier": 12, "hidden_act": "silu", "hidden_size": 2048,
    "intermediate_size": 8192,
    "layer_types": ["attention" if i % 10 == 5 else "mamba"
                    for i in range(40)],
    "logits_scaling": 8, "mamba_chunk_size": 256, "mamba_conv_bias": True,
    "mamba_d_conv": 4, "mamba_d_head": 64, "mamba_d_state": 128,
    "mamba_expand": 2, "mamba_n_groups": 1, "mamba_n_heads": 64,
    "mamba_proj_bias": False, "max_position_embeddings": 131072,
    "model_type": "granitemoehybrid", "normalization_function": "rmsnorm",
    "num_attention_heads": 32, "num_experts_per_tok": 0,
    "num_hidden_layers": 40, "num_key_value_heads": 8,
    "num_local_experts": 0, "position_embedding_type": "nope",
    "residual_multiplier": 0.22, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "rope_theta": 10000,
    "shared_intermediate_size": 8192, "tie_word_embeddings": True,
    "vocab_size": 100352,
}
# the keys the app (`apps/granite_4_h_micro.build`) and the reference read
ARGS = ("hidden_size", "vocab_size", "layer_types", "mamba_n_heads",
        "mamba_d_head", "mamba_d_state", "mamba_n_groups", "mamba_d_conv",
        "mamba_expand", "mamba_chunk_size", "num_attention_heads",
        "num_key_value_heads", "shared_intermediate_size", "rms_norm_eps",
        "embedding_multiplier", "residual_multiplier", "logits_scaling",
        "attention_multiplier")
LINEAR_STD = 0.02
NORM = (1.0, 0.1)
# the variance of torch's default Conv1d initialisation, U(-1/2, 1/2) for
# a depthwise kernel of 4 taps
CONV_STD = 0.5 / math.sqrt(3)
CHECK = {
    "kind": "relative",
    "control_dtype": "bfloat16",
    "limits": {"max_rel_err": 1e-4},
    "readings": "lower (the program, 12 seeds, 2 prompts each): 6.79e-6 "
                "to 1.008e-5 (one prompt each, graphs reading the weights "
                "in place: 5.56e-6 to 1.01e-5); "
                "upper: the program with TF32 allowed in cuBLAS (3 seeds) "
                "1.63e-3 to 2.65e-3, the reference in bfloat16 (3 seeds) "
                "3.95e-2 to 5.26e-2; HT_PRECISION=default alone reads as "
                "the program (torch keeps TF32 off for matmul); the limit "
                "sits 9.9x above the program's largest and 16x below "
                "TF32's smallest; the reference's logits: std across the "
                "vocabulary 0.113-0.114, a row's largest probability "
                "1.6e-5 to 2.2e-5, not one-hot (H100 80GB HBM3, 700 W)",
}
ASSUMED = {
    "deployment": "a serving engine's prefill of one 4096-token prompt "
                  "(RAG context or chat history), batch 1, one in flight: "
                  "the step users feel as time to first token; the output "
                  "is the last position's logits, as a first decode step "
                  "samples from them",
    "tokens": "uniform over the vocabulary, a new prompt from the ring "
              "each frame; the ring is 2 prompts, as the 822-MB embedding "
              "table (tied to the LM head, which reads it whole each frame) "
              "counts in its bytes a frame",
    "embed": "the one weight declared a ring input, of kind shared: one "
             "draw, every slot the same tensor, bound each frame and held "
             "once, so the ring's bytes a frame hold what a frame reads "
             "whole and the ring is not 4,800 prompts of 16 KB, each "
             "warmed up before the window; every other weight is bound "
             "once",
    "linear_w": "normal(0, 0.02): the embedding (tied to the LM head), "
                "in_proj, out_proj, q, k, v, o and the MLP's two",
    "norm_w": "normal(1, 0.1): every RMSNorm's weight, the gated one too",
    "conv": "normal(0, 0.2887) for the causal conv's weights and bias: the "
            "variance of torch's default Conv1d init, U(-1/2, 1/2) for 4 "
            "taps, so that x, B and C are not negligible",
    "mamba": "Mamba-2's published initialisation: A_log = log U(1, 16); "
             "dt_bias the inverse softplus of dt = exp U(log 1e-3, "
             "log 1e-1); D = 1",
    "precision": "float32 where the model ships bfloat16: the port's "
                 "contractions compute in f32 with TF32 off, and 16-bit "
                 "inputs would be upcast",
}


def _normal(name, shape, mean, std) -> dict:
    return {"name": name, "kind": "normal", "dtype": "float32",
            "mean": mean, "std": std, "shape": list(shape)}


def inputs(args: dict) -> list:
    """The app's inputs, in its order: the tokens, then each weight."""
    from halide_tpu_torch.models.granite_hybrid import GraniteParams
    p = GraniteParams(**args)
    out = [{"name": "tokens", "kind": "uniform", "dtype": "int32",
            "low": 0, "high": args["vocab_size"],
            "shape": [["h", 0], ["w", 0]], "ring": True}]
    for name, shape in p.weight_shapes().items():
        kind = name.split("_", 1)[-1]
        if name == "embed":
            out.append(dict(_normal(name, shape, 0.0, LINEAR_STD),
                            kind="shared", law="normal", ring=True))
        elif "norm" in kind:
            out.append(_normal(name, shape, *NORM))
        elif kind in ("A_log", "dt_bias"):
            out.append({"name": name, "kind": "mamba2", "dtype": "float32",
                        "param": kind, "shape": list(shape)})
        elif kind == "D":
            out.append(_normal(name, shape, 1.0, 0.0))
        elif kind.startswith("conv"):
            out.append(_normal(name, shape, 0.0, CONV_STD))
        else:
            out.append(_normal(name, shape, 0.0, LINEAR_STD))
    return out


def config(published=None, sizes=None,
           name: str = "granite_4_h_micro") -> dict:
    """The configuration: `published` the model's config.json keys (the
    tests give a small one), `sizes` a size class -> [seq, batch]."""
    published = dict(published or PUBLISHED)
    sizes = sizes or {"prefill4k": [4096, 1]}
    args = {k: published[k] for k in ARGS}
    return {
        **published,
        "name": name,
        "source": SOURCE + " (layer_types; mamba_n_heads, mamba_d_head, "
                  "mamba_d_state, mamba_n_groups, mamba_d_conv, "
                  "mamba_expand, mamba_chunk_size)",
        "app": "granite_4_h_micro",
        "args": args,
        "size_args": ["seq", "batch"],
        "sizes": {k: list(v) for k, v in sizes.items()},
        "precision": "float32",
        "inputs": inputs(args),
        "check": json.loads(json.dumps(CHECK)),
        "reduced": [],
        "assumed": dict(ASSUMED),
    }


def dumps(cfg: dict) -> str:
    """The configuration as JSON, two-space indented, one input a line."""
    specs = cfg["inputs"]
    text = json.dumps({**cfg, "inputs": []}, indent=2)
    lines = ",\n".join("    " + json.dumps(s) for s in specs)
    return text.replace('"inputs": []', '"inputs": [\n' + lines + "\n  ]",
                        1) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", action="append",
                    help="CLASS=SEQxBATCH, e.g. prefill4k=4096x1")
    ap.add_argument("--out", type=Path,
                    default=HERE / "configs" / "granite_4_h_micro.json")
    a = ap.parse_args(argv)
    sizes = None
    if a.size:
        sizes = {}
        for s in a.size:
            cls, dims = s.split("=")
            seq, batch = dims.split("x")
            sizes[cls] = [int(seq), int(batch)]
    cfg = config(sizes=sizes)
    if a.out.is_file():
        old = json.loads(a.out.read_text())
        if (old.get("args"), old.get("sizes")) == (cfg["args"],
                                                    cfg["sizes"]):
            for k in ("work_method", "work"):
                if k in old:
                    cfg[k] = old[k]
    a.out.write_text(dumps(cfg))
    return 0


if __name__ == "__main__":
    sys.exit(main())

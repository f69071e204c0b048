"""granite_4_h_micro: the forward pass of IBM's Granite 4.0-H Micro
(granitemoehybrid; ibm-granite/granite-4.0-h-micro's config.json), 36
Mamba-2 mixers and 4 GQA attention layers, over one prompt of `seq` tokens
a batch row, to the last position's logits (models/granite_hybrid.py).
Built at the published widths by default; every config.json key the model
reads may be given, so that the tests build a small one. A `seq` that is
not a multiple of `mamba_chunk_size` raises."""
from __future__ import annotations

import numpy as np
import torch

from ..models import granite_hybrid as gh
from ..models import granite_hybrid_ref as ref

from . import App, register

# config.json's layer_types: attention at layers 5, 15, 25 and 35
LAYER_TYPES = tuple(gh.ATTENTION if i % 10 == 5 else gh.MAMBA
                    for i in range(40))
# the variance of torch's default Conv1d initialisation, U(-1/2, 1/2) for
# a depthwise kernel of 4 taps
CONV_STD = 0.5 / 3 ** 0.5


def random_weights(p: gh.GraniteParams, seed: int = 0) -> dict:
    """numpy inputs in the app's layouts: tokens uniform over the
    vocabulary; linear weights normal(0, 0.02), norm weights normal(1,
    0.1), the causal conv's weights and bias normal(0, CONV_STD), A_log =
    log U(1, 16), dt_bias the inverse softplus of exp U(log 1e-3, log
    1e-1), D = 1 (Mamba-2's initialisation)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, p.vocab, (p.batch, p.seq),
                                  dtype=np.int32)}
    for name, shape in p.weight_shapes().items():
        kind = name.split("_", 1)[-1]
        if "norm" in kind:
            w = rng.normal(1.0, 0.1, shape)
        elif kind == "A_log":
            w = np.log(rng.uniform(1.0, 16.0, shape))
        elif kind == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
            w = dt + np.log(-np.expm1(-dt))
        elif kind == "D":
            w = np.ones(shape)
        elif kind.startswith("conv"):
            w = rng.normal(0.0, CONV_STD, shape)
        else:
            w = rng.normal(0.0, 0.02, shape)
        out[name] = w.astype(np.float32)
    return out


def config_args(p: gh.GraniteParams) -> dict:
    """The config.json keys the model reads, as the reference takes them."""
    return {"hidden_size": p.hidden, "vocab_size": p.vocab,
            "layer_types": list(p.layer_types),
            "mamba_n_heads": p.m_heads, "mamba_d_head": p.m_head_dim,
            "mamba_d_state": p.d_state, "mamba_n_groups": 1,
            "mamba_d_conv": p.d_conv, "mamba_expand": p.d_inner // p.hidden,
            "mamba_chunk_size": p.chunk,
            "num_attention_heads": p.heads,
            "num_key_value_heads": p.kv_heads,
            "shared_intermediate_size": p.intermediate,
            "rms_norm_eps": p.eps, "embedding_multiplier": p.emb_mult,
            "residual_multiplier": p.res_mult,
            "logits_scaling": p.logits_scaling,
            "attention_multiplier": p.attn_mult}


@register("granite_4_h_micro")
def build(seq: int = 4096, batch: int = 1, hidden_size: int = 2048,
          vocab_size: int = 100352, layer_types=LAYER_TYPES,
          hidden: bool = False, **config) -> App:
    p = gh.GraniteParams(hidden_size=hidden_size, vocab_size=vocab_size,
                         layer_types=layer_types, seq=seq, batch=batch,
                         **config)
    pipeline, params, *extra = gh.build(p, hidden=hidden)
    args = config_args(p)

    def make_inputs(seed=0):
        return random_weights(p, seed)

    def reference(**data):
        t = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in data.items()}
        return ref.reference(t, args).numpy()

    app = App("granite_4_h_micro", pipeline, list(params.values()),
              make_inputs, reference, [p.vocab, batch],
              megapixels=seq * batch / 1e6, tolerance=1e-4, atol=1e-5)
    app.params = p
    app.config_args = args
    # with `hidden`: the final-normed hidden states at every position,
    # (hidden, seq, batch), over the same Funcs
    app.hidden_pipeline = extra[0] if extra else None
    return app

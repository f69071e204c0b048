"""Plain PyTorch reference of the Granite 4.0-H (granitemoehybrid) forward
pass, from its equations (transformers' modeling_granitemoehybrid and
modeling_mamba2): the Mamba-2 state recurrence taken step by step over the
positions, as the SSM's definition states it, and attention with an
explicit causal mask. No chunking, no kernel, no cache. It imports nothing
of the port, so that the port's chunked SSD (models/granite_hybrid.py) is
held against an independent statement of the model.

`inputs` maps the app's input names to tensors in its layouts
(`GraniteParams.weight_shapes`; `tokens` (batch, seq) int32); `args` the
model's config.json keys (`hidden_size`, `layer_types`, `mamba_*`, ...).
float32 with TF32 off in cuBLAS and cuDNN, the flags restored after;
`dtype` (a lower-precision control) is the type every layer computes in,
the result coming back in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _rms(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _mamba(x, W, i, a, dtype):
    """The Mamba-2 mixer on x (batch, seq, hidden)."""
    nh, hd, n = a["mamba_n_heads"], a["mamba_d_head"], a["mamba_d_state"]
    ni = nh * hd
    bsz, seq, _ = x.shape
    zxbcdt = x @ W(f"l{i}_in_proj").t()
    z, xbc, dt = zxbcdt.split([ni, ni + 2 * n, nh], dim=-1)
    conv_w = W(f"l{i}_conv_w")                       # (channels, kernel)
    k = conv_w.shape[1]
    xbc = F.conv1d(xbc.transpose(1, 2), conv_w.unsqueeze(1),
                   W(f"l{i}_conv_b"), padding=k - 1,
                   groups=conv_w.shape[0])[..., :seq].transpose(1, 2)
    xbc = F.silu(xbc)
    xs, B, C = xbc.split([ni, n, n], dim=-1)
    xs = xs.reshape(bsz, seq, nh, hd)
    dt = F.softplus(dt + W(f"l{i}_dt_bias"))          # (batch, seq, heads)
    A = -torch.exp(W(f"l{i}_A_log"))
    D = W(f"l{i}_D")
    # S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T; y_t = S_t C_t + D x_t
    decay = torch.exp(dt * A)[..., None, None]        # (batch, seq, heads)
    dtx = (dt[..., None] * xs)[..., None]             # (.., heads, hd, 1)
    Bt = B[:, :, None, None, :]                       # (.., 1, 1, state)
    state = torch.zeros(bsz, nh, hd, n, dtype=dtype, device=x.device)
    y = torch.empty(bsz, seq, nh, hd, dtype=dtype, device=x.device)
    for t in range(seq):
        state = torch.addcmul(state * decay[:, t], dtx[:, t], Bt[:, t])
        y[:, t] = (state @ C[:, t, None, :, None]).squeeze(-1)
    y = (y + D[:, None] * xs).reshape(bsz, seq, ni)
    y = _rms(y * F.silu(z), W(f"l{i}_gnorm"), a["rms_norm_eps"])
    out_w = W(f"l{i}_out_proj")                       # (hidden, heads, hd)
    return y @ out_w.reshape(out_w.shape[0], -1).t()


def _attention(x, W, i, a):
    """Causal grouped-query attention without positions on x."""
    bsz, seq, hidden = x.shape
    nq, nk = a["num_attention_heads"], a["num_key_value_heads"]
    hd = hidden // nq

    def proj(name, heads):
        w = W(name).reshape(heads * hd, hidden)
        return (x @ w.t()).reshape(bsz, seq, heads, hd).transpose(1, 2)

    q, k, v = proj(f"l{i}_q", nq), proj(f"l{i}_k", nk), proj(f"l{i}_v", nk)
    k = k.repeat_interleave(nq // nk, dim=1)
    v = v.repeat_interleave(nq // nk, dim=1)
    scores = (q @ k.transpose(-1, -2)) * a["attention_multiplier"]
    mask = torch.ones(seq, seq, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    o = torch.softmax(scores, dim=-1) @ v            # (batch, heads, seq, hd)
    o = o.transpose(1, 2).reshape(bsz, seq, hidden)
    return o @ W(f"l{i}_o").reshape(hidden, hidden).t()


def forward(inputs: dict, args: dict, dtype=torch.float32,
            hidden: bool = False):
    """-> the last position's logits (batch, vocab), and with `hidden` the
    final-normed hidden states (batch, seq, hidden) too."""
    def W(name):
        return inputs[name].to(dtype)

    a, eps = args, args["rms_norm_eps"]
    emb = W("embed")
    h = emb[inputs["tokens"].long()] * a["embedding_multiplier"]
    for i, kind in enumerate(a["layer_types"]):
        x = _rms(h, W(f"l{i}_norm1"), eps)
        mixed = _mamba(x, W, i, a, dtype) if kind == "mamba" \
            else _attention(x, W, i, a)
        h = h + mixed * a["residual_multiplier"]
        x = _rms(h, W(f"l{i}_norm2"), eps)
        g, u = (x @ W(f"l{i}_mlp_in").t()).chunk(2, dim=-1)
        h = h + (F.silu(g) * u) @ W(f"l{i}_mlp_out").t() \
            * a["residual_multiplier"]
    hn = _rms(h, W("final_norm"), eps)
    logits = (hn[:, -1] @ emb.t()) / a["logits_scaling"]
    if hidden:
        return logits.float(), hn.float()
    return logits.float()


def reference(inputs: dict, args: dict, dtype=None, hidden: bool = False):
    """`forward` in `dtype` (float32 by default) with TF32 off."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, dnn.allow_tf32)
    mm.allow_tf32 = dnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return forward(inputs, args, dtype or torch.float32, hidden)
    finally:
        mm.allow_tf32, dnn.allow_tf32 = saved

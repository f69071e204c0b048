"""Granite 4.0-H (granitemoehybrid) forward pass on the Func DSL: Mamba-2
mixers and grouped-query attention layers, each followed by the same gated
MLP (reference: transformers' modeling_granitemoehybrid and modeling_mamba2;
Dao and Gu 2024, "Transformers are SSMs", arXiv:2405.21060, the SSD
algorithm). The output is the last position's logits, Func dims (vocab,
batch); `build(p, hidden=True)` adds a second pipeline over the same
Funcs, of the final-normed hidden states at every position (hidden, seq,
batch).

Every projection is one `nn.linear` einsum (cuBLAS on the card); every
other stage one element-wise or reducing Func, computed at root (a stage
kernel on the card). The Mamba-2 mixer is SSD in chunked form, chunks of
`chunk` positions (c) of `l` positions each:

- dt = softplus(dt_raw + dt_bias), dA = dt * A with A = -exp(A_log), and
  dA's cumulative sum within each chunk (`cum`, a product with the lower
  triangle: an einsum);
- within a chunk, Y_diag[l] = sum_{s<=l} (C_l . B_s) exp(cum_l - cum_s)
  dt_s x_s, the differences taken inside one chunk only;
- each chunk's state S_c = sum_l B_l exp(cum_end - cum_l) dt_l x_l;
- the state entering each chunk, Sin[c] = exp(cum_end[c-1]) Sin[c-1] +
  S_{c-1} from Sin[0] = 0: an RDom update that updates._try_scan hands to
  the scan kernel K2b (one launch a mixer);
- Y_off[l] = exp(cum_l) C_l . Sin[c]; y = Y_diag + Y_off + D x, gated by
  silu(z) and RMS-normed over all its channels, then out_proj.

Weights are ImageParams in torch's layouts read minor-first (a Linear's
(out, in) is Func (in, out)); the head-split projections read them as
(in, head dim, head) and out_proj and o_proj as (head dim, head, out), the
same memory. Layer i's inputs are named `l{i}_...`.
"""
from __future__ import annotations

from typing import Dict, Sequence

import halide_tpu_torch as hl

from . import nn

MAMBA, ATTENTION = "mamba", "attention"
# the masked keys' score in attention's maximum (below any real score)
_NEG = -3.0e38


class GraniteParams:
    """The model's settings under the names of its config.json, and the
    prompt's `seq` and `batch`."""

    def __init__(self, hidden_size: int = 2048, vocab_size: int = 100352,
                 layer_types: Sequence[str] = (MAMBA,) * 5 + (ATTENTION,),
                 mamba_n_heads: int = 64, mamba_d_head: int = 64,
                 mamba_d_state: int = 128, mamba_n_groups: int = 1,
                 mamba_d_conv: int = 4, mamba_expand: int = 2,
                 mamba_chunk_size: int = 256,
                 num_attention_heads: int = 32,
                 num_key_value_heads: int = 8,
                 shared_intermediate_size: int = 8192,
                 rms_norm_eps: float = 1e-5,
                 embedding_multiplier: float = 12.0,
                 residual_multiplier: float = 0.22,
                 logits_scaling: float = 8.0,
                 attention_multiplier: float = 0.015625,
                 seq: int = 256, batch: int = 1):
        self.hidden = hidden_size
        self.vocab = vocab_size
        self.layer_types = tuple(layer_types)
        self.m_heads = mamba_n_heads
        self.m_head_dim = mamba_d_head
        self.d_state = mamba_d_state
        self.d_conv = mamba_d_conv
        self.chunk = mamba_chunk_size
        self.heads = num_attention_heads
        self.kv_heads = num_key_value_heads
        self.head_dim = hidden_size // num_attention_heads
        self.intermediate = shared_intermediate_size
        self.eps = rms_norm_eps
        self.emb_mult = embedding_multiplier
        self.res_mult = residual_multiplier
        self.logits_scaling = logits_scaling
        self.attn_mult = attention_multiplier
        self.seq = seq
        self.batch = batch
        self.d_inner = mamba_n_heads * mamba_d_head
        bad = [t for t in self.layer_types if t not in (MAMBA, ATTENTION)]
        if bad:
            raise ValueError(f"unknown layer types {sorted(set(bad))}")
        if mamba_n_groups != 1:
            raise ValueError(f"mamba_n_groups {mamba_n_groups}: the model "
                             "takes one group of B and C")
        if mamba_expand * hidden_size != self.d_inner:
            raise ValueError(f"mamba_expand {mamba_expand} x hidden "
                             f"{hidden_size} is not {mamba_n_heads} heads "
                             f"of {mamba_d_head}")
        if hidden_size % num_attention_heads or \
                num_attention_heads % num_key_value_heads:
            raise ValueError("the attention heads do not divide the hidden "
                             "size, or the KV heads the query heads")
        if seq <= 0 or seq % mamba_chunk_size:
            raise ValueError(f"seq {seq} is not a positive multiple of the "
                             f"Mamba-2 chunk size {mamba_chunk_size}")

    @property
    def conv_dim(self) -> int:
        """The channels of the causal conv: x, B and C."""
        return self.d_inner + 2 * self.d_state

    @property
    def in_proj(self) -> int:
        """in_proj's outputs: z, xBC and dt."""
        return self.d_inner + self.conv_dim + self.m_heads

    def weight_shapes(self) -> Dict[str, tuple]:
        """Every weight's torch shape, by input name, in the app's order
        (each layer's norms, mixer, MLP; then the final norm)."""
        H, P, NH = self.hidden, self.m_head_dim, self.m_heads
        D, NQ, NK = self.head_dim, self.heads, self.kv_heads
        out = {"embed": (self.vocab, H)}
        for i, kind in enumerate(self.layer_types):
            out[f"l{i}_norm1"] = (H,)
            if kind == MAMBA:
                out.update({f"l{i}_in_proj": (self.in_proj, H),
                            f"l{i}_conv_w": (self.conv_dim, self.d_conv),
                            f"l{i}_conv_b": (self.conv_dim,),
                            f"l{i}_dt_bias": (NH,),
                            f"l{i}_A_log": (NH,),
                            f"l{i}_D": (NH,),
                            f"l{i}_gnorm": (self.d_inner,),
                            f"l{i}_out_proj": (H, NH, P)})
            else:
                out.update({f"l{i}_q": (NQ, D, H), f"l{i}_k": (NK, D, H),
                            f"l{i}_v": (NK, D, H), f"l{i}_o": (H, NQ, D)})
            out.update({f"l{i}_norm2": (H,),
                        f"l{i}_mlp_in": (2 * self.intermediate, H),
                        f"l{i}_mlp_out": (H, self.intermediate)})
        out["final_norm"] = (H,)
        return out


def _mamba(p: GraniteParams, i: int, xn, P):
    """Layer i's Mamba-2 mixer on the normed stream xn (hidden, seq,
    batch) -> its output (hidden, l, c, batch)."""
    Q, NC = p.chunk, p.seq // p.chunk
    NI, N, NH, HD = p.d_inner, p.d_state, p.m_heads, p.m_head_dim
    t, b, o = hl.Var("t"), hl.Var("b"), hl.Var("o")
    hh, pd, n = hl.Var("hh"), hl.Var("pd"), hl.Var("n")
    l, s, c = hl.Var("l"), hl.Var("s"), hl.Var("c")
    pre = f"l{i}_"
    zx = nn.linear(pre + "zxbcdt", P(pre + "in_proj", 2), xn, p.hidden, [o],
                   [t, b])
    conv_w, conv_b = P(pre + "conv_w", 2), P(pre + "conv_b", 1)
    K = p.d_conv

    def conv(chan, pos):
        """silu of the causal depthwise conv of xBC's channel `chan` at
        position `pos` (zero before the first)."""
        acc = conv_b[chan]
        for k in range(K):
            u = pos + (k - (K - 1))
            acc = acc + conv_w[k, chan] * hl.select(
                u >= 0, zx[NI + chan, hl.clamp(u, 0, p.seq - 1), b], 0.0)
        return nn.silu(acc)

    pos = l + Q * c
    xs = hl.Func(pre + "x")
    xs[pd, hh, l, c, b] = conv(pd + HD * hh, pos)
    Bs = hl.Func(pre + "B")
    Bs[n, l, c, b] = conv(NI + n, pos)
    Cs = hl.Func(pre + "C")
    Cs[n, l, c, b] = conv(NI + N + n, pos)
    dt = hl.Func(pre + "dt")
    dt[hh, l, c, b] = nn.softplus(zx[NI + p.conv_dim + hh, pos, b]
                                  + P(pre + "dt_bias", 1)[hh])
    dA = hl.Func(pre + "dA")
    dA[hh, l, c, b] = dt[hh, l, c, b] * -hl.exp(P(pre + "A_log", 1)[hh])
    for f in (xs, Bs, Cs, dt, dA):
        f.compute_root()
    # dA's inclusive cumulative sum within each chunk
    j = hl.Var("j")
    tri = hl.Func(pre + "tri")
    tri[j, l] = hl.select(j <= l, 1.0, 0.0)
    rj = hl.RDom(0, Q, f"r_{pre}cum")
    cum = hl.Func(pre + "cum")
    cum[hh, l, c, b] = hl.sum(tri[rj.x, l] * dA[hh, rj.x, c, b])
    cum.compute_root()
    # the intra-chunk part
    rn = hl.RDom(0, N, f"r_{pre}cb")
    cb = hl.Func(pre + "CB")
    cb[s, l, c, b] = hl.sum(Cs[rn.x, l, c, b] * Bs[rn.x, s, c, b])
    cb.compute_root()
    lm = hl.Func(pre + "L")
    lm[s, l, hh, c, b] = hl.select(
        s <= l, hl.exp(cum[hh, l, c, b] - cum[hh, s, c, b]), 0.0) \
        * cb[s, l, c, b] * dt[hh, s, c, b]
    lm.compute_root()
    rs = hl.RDom(0, Q, f"r_{pre}yd")
    ydiag = hl.Func(pre + "Ydiag")
    ydiag[pd, hh, l, c, b] = hl.sum(lm[rs.x, l, hh, c, b]
                                    * xs[pd, hh, rs.x, c, b])
    ydiag.compute_root()
    # each chunk's state, and the state entering each chunk (K2b)
    wx = hl.Func(pre + "wx")
    wx[pd, hh, l, c, b] = hl.exp(cum[hh, Q - 1, c, b] - cum[hh, l, c, b]) \
        * dt[hh, l, c, b] * xs[pd, hh, l, c, b]
    wx.compute_root()
    rl = hl.RDom(0, Q, f"r_{pre}st")
    st = hl.Func(pre + "S")
    st[pd, n, hh, c, b] = hl.sum(Bs[n, rl.x, c, b] * wx[pd, hh, rl.x, c, b])
    st.compute_root()
    sin = hl.Func(pre + "Sin")
    sin[pd, n, hh, c, b] = 0.0
    if NC > 1:
        rc = hl.RDom(1, NC - 1, f"r_{pre}scan")
        sin[pd, n, hh, rc.x, b] = \
            hl.exp(cum[hh, Q - 1, rc.x - 1, b]) * sin[pd, n, hh, rc.x - 1, b] \
            + st[pd, n, hh, rc.x - 1, b]
    sin.compute_root()
    rn2 = hl.RDom(0, N, f"r_{pre}cs")
    cs = hl.Func(pre + "CS")
    cs[pd, hh, l, c, b] = hl.sum(Cs[rn2.x, l, c, b] * sin[pd, rn2.x, hh, c, b])
    cs.compute_root()
    # y, gated by silu(z), normed over its d_inner channels, out_proj
    yg = hl.Func(pre + "yg")
    yg[pd, hh, l, c, b] = (
        ydiag[pd, hh, l, c, b] + hl.exp(cum[hh, l, c, b]) * cs[pd, hh, l, c, b]
        + P(pre + "D", 1)[hh] * xs[pd, hh, l, c, b]) \
        * nn.silu(zx[pd + HD * hh, pos, b])
    yg.compute_root()
    _ss, yn = nn.rms_norm(pre + "gnorm", yg, P(pre + "gnorm", 1), NI, p.eps,
                          [l, c, b], lead=2, extents=[HD, NH])
    return _out_proj(pre, P(pre + "out_proj", 3), yn, HD, NH, [l, c, b])


def _out_proj(name, w, x, d: int, heads: int, rest):
    """f[e, *rest] = sum over (head dim, head) of w[rd, rh, e] x[rd, rh,
    *rest]: out_proj and o_proj, one einsum."""
    e = hl.Var("e")
    r = hl.RDom(0, d, 0, heads, f"r_{name}out")
    f = hl.Func(name + "mixer")
    f[(e,) + tuple(rest)] = hl.sum(w[r.x, r.y, e]
                                   * x[(r.x, r.y) + tuple(rest)])
    f.compute_root()
    return f


def _attention(p: GraniteParams, i: int, xn, P):
    """Layer i's causal GQA attention without positions on the normed
    stream xn -> its output (hidden, seq, batch)."""
    d, hq, g = hl.Var("d"), hl.Var("hq"), hl.Var("g")
    t, b, q, k = hl.Var("t"), hl.Var("b"), hl.Var("q"), hl.Var("k")
    pre = f"l{i}_"
    D, H = p.head_dim, p.hidden
    rep = p.heads // p.kv_heads
    qf = nn.linear(pre + "q", P(pre + "q", 3), xn, H, [d, hq], [t, b])
    kf = nn.linear(pre + "k", P(pre + "k", 3), xn, H, [d, g], [t, b])
    vf = nn.linear(pre + "v", P(pre + "v", 3), xn, H, [d, g], [t, b])
    rd = hl.RDom(0, D, f"r_{pre}qk")
    raw = hl.Func(pre + "scores")
    raw[q, k, hq, b] = hl.sum(qf[rd.x, hq, q, b] * kf[rd.x, hq / rep, k, b])
    raw.compute_root()
    rk = hl.RDom(0, p.seq, f"r_{pre}max")
    mx = hl.Func(pre + "max")
    mx[q, hq, b] = hl.maximum(hl.select(rk.x <= q, raw[q, rk.x, hq, b],
                                        _NEG))
    mx.compute_root()
    ex = hl.Func(pre + "exp")
    ex[q, k, hq, b] = hl.select(
        k <= q, hl.exp(p.attn_mult * (raw[q, k, hq, b] - mx[q, hq, b])), 0.0)
    ex.compute_root()
    rk2 = hl.RDom(0, p.seq, f"r_{pre}sum")
    sm = hl.Func(pre + "sum")
    sm[q, hq, b] = hl.sum(ex[q, rk2.x, hq, b])
    sm.compute_root()
    rk3 = hl.RDom(0, p.seq, f"r_{pre}pv")
    pv = hl.Func(pre + "pv")
    pv[d, hq, q, b] = hl.sum(ex[q, rk3.x, hq, b] * vf[d, hq / rep, rk3.x, b])
    pv.compute_root()
    ao = hl.Func(pre + "attn")
    ao[d, hq, t, b] = pv[d, hq, t, b] / sm[t, hq, b]
    ao.compute_root()
    return _out_proj(pre, P(pre + "o", 3), ao, D, p.heads, [t, b])


def build(p: GraniteParams, hidden: bool = False):
    """-> (pipeline, params: name -> ImageParam, in the app's order), and
    with `hidden` the hidden states' pipeline third."""
    params: Dict[str, hl.ImageParam] = {}

    def P(name, dims, t=hl.Float(32)):
        if name not in params:
            params[name] = hl.ImageParam(t, dims, name)
        return params[name]

    e, t, b, j = hl.Var("e"), hl.Var("t"), hl.Var("b"), hl.Var("j")
    Q, H = p.chunk, p.hidden
    tokens = P("tokens", 2, hl.Int(32))
    emb = P("embed", 2)
    h = hl.Func("embed_h")
    h[e, t, b] = emb[e, hl.clamp(tokens[t, b], 0, p.vocab - 1)] * p.emb_mult
    h.compute_root()
    for i, kind in enumerate(p.layer_types):
        pre = f"l{i}_"
        _ss, xn = nn.rms_norm(pre + "norm1", h, P(pre + "norm1", 1), H,
                              p.eps, [t, b])
        h1 = hl.Func(pre + "h1")
        if kind == MAMBA:
            mo = _mamba(p, i, xn, P)
            h1[e, t, b] = h[e, t, b] + p.res_mult * mo[e, t % Q, t / Q, b]
        else:
            ao = _attention(p, i, xn, P)
            h1[e, t, b] = h[e, t, b] + p.res_mult * ao[e, t, b]
        h1.compute_root()
        _ss, xn2 = nn.rms_norm(pre + "norm2", h1, P(pre + "norm2", 1), H,
                               p.eps, [t, b])
        gu = nn.linear(pre + "mlp_in", P(pre + "mlp_in", 2), xn2, H, [j],
                       [t, b])
        act = hl.Func(pre + "act")
        act[j, t, b] = nn.silu(gu[j, t, b]) * gu[j + p.intermediate, t, b]
        act.compute_root()
        dn = nn.linear(pre + "mlp_out", P(pre + "mlp_out", 2), act,
                       p.intermediate, [e], [t, b])
        h = hl.Func(pre + "h2")
        h[e, t, b] = h1[e, t, b] + p.res_mult * dn[e, t, b]
        h.compute_root()
    last = hl.Func("last_h")
    last[e, b] = h[e, p.seq - 1, b]
    last.compute_root()
    _ss, hf = nn.rms_norm("final_norm", last, P("final_norm", 1), H, p.eps,
                          [b])
    v = hl.Var("v")
    rh = hl.RDom(0, H, "r_lm_head")
    logits = hl.Func("logits")
    logits[v, b] = hl.sum(emb[rh.x, v] * hf[rh.x, b]) / p.logits_scaling
    ordered = {k: params[k] for k in ["tokens"] + list(p.weight_shapes())}
    if not hidden:
        return hl.Pipeline(logits), ordered
    _ss, hs = nn.rms_norm("final_norm_all", h, P("final_norm", 1), H, p.eps,
                          [t, b])
    return hl.Pipeline(logits), ordered, hl.Pipeline(hs)

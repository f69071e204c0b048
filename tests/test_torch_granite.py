"""The granite_4_h_micro app (halide_tpu_torch/models/granite_hybrid.py,
apps/granite_4_h_micro.py) against its plain reference (models/
granite_hybrid_ref.py), on the CPU at a small size: hidden 64, 4 Mamba-2
heads of 16 with d_state 16, 4 query and 2 KV heads of 16, chunk 16, seq
64 (4 chunks), layers [mamba, mamba, attention, mamba], vocab 512, seeded
random weights.

The last position's logits and the final-normed hidden states at every
position; one Mamba-2 mixer's chunked SSD against the step-by-step
recurrence and one GQA attention against the reference's, each as its own
pipeline; the inter-chunk state update taken by `updates._try_scan` (K2b's
plain version here); the contractions on the einsum path where its
threshold lets them; the stage kernels' source built with g++ against
eval_torch; a seq that is not a multiple of the chunk raising; the app at
its published widths. The reference holds the model in float64 where a
test says so, so that the port's float32 rounding is what is measured."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import halide_tpu_torch as ht
from halide_tpu_torch import eval_torch, spans
from halide_tpu_torch.apps import get
from halide_tpu_torch.apps.granite_4_h_micro import (config_args,
                                                     random_weights)
from halide_tpu_torch.models import granite_hybrid as gh
from halide_tpu_torch.models import granite_hybrid_ref as ref
from halide_tpu_torch.ops import group_kernel as gk
from halide_tpu_torch.ops import scan_kernel
from halide_tpu_torch.ops import stage_kernel as sk

SMALL = dict(hidden_size=64, vocab_size=512,
             layer_types=("mamba", "mamba", "attention", "mamba"),
             mamba_n_heads=4, mamba_d_head=16, mamba_expand=1,
             mamba_d_state=16, mamba_chunk_size=16, num_attention_heads=4,
             num_key_value_heads=2, shared_intermediate_size=128)
SEQ = 64
# normwise relative error, max |got - want| / max |want|, of float32
# against the float64 reference: 40 ulps of float32 (1.2e-7 each) leave
# room for the sums' orders; a float16 model reads ~1e-3
LIMIT = 5e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _app(batch=1, **kw):
    app = get("granite_4_h_micro")(seq=SEQ, batch=batch, **SMALL, **kw)
    data = app.make_inputs(11)
    app.bind(data, "cpu")
    return app, data


def _ref(app, data, hidden=False):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).double()
         if v.dtype == np.float32 else torch.from_numpy(v)
         for k, v in data.items()}
    return ref.reference(t, app.config_args, torch.float64, hidden=hidden)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("einsum", [False, True])
def test_last_logits_against_the_reference(batch, einsum, monkeypatch):
    """Below the einsum threshold every sum is a torch reduction; with it
    at 1 every contraction takes the einsum path, and the counters say
    so (none unrolled or dense)."""
    if einsum:
        monkeypatch.setattr(eval_torch, "_EINSUM_MIN_FULL", 1)
    app, data = _app(batch)
    c0 = spans.counters()
    got = app.pipeline.realize(app.output_sizes, device="cpu").to_numpy()
    c1 = spans.counters()
    want = _ref(app, data).numpy()
    assert got.shape == want.shape == (batch, SMALL["vocab_size"])
    assert _rel(got, want) < LIMIT
    # the logits are not one-hot: a row's largest probability
    assert torch.softmax(torch.from_numpy(want), 1).max() < 0.5
    assert c1["contract.unrolled"] == c0["contract.unrolled"]
    assert c1["contract.dense"] == c0["contract.dense"]
    einsums = c1["contract.einsum"] - c0["contract.einsum"]
    # per mixer 9 sums, per attention 7, per layer 3 more, and the final
    # norm's and the LM head's
    assert einsums == (3 * 12 + 10 + 2 if einsum else 0)


def test_hidden_states_at_every_position():
    app, data = _app(2, hidden=True)
    got = app.hidden_pipeline.realize([64, SEQ, 2], device="cpu").to_numpy()
    _logits, want = _ref(app, data, hidden=True)
    assert got.shape == tuple(want.shape) == (2, SEQ, 64)
    assert _rel(got, want.numpy()) < LIMIT


def _one_layer(kind, batch=2):
    """One mixer as its own pipeline, reading the normed stream `xn`
    (hidden, seq, batch) -> (pipeline, params, GraniteParams, numpy data,
    the reference's output (batch, seq, hidden) in float64)."""
    p = gh.GraniteParams(**SMALL, seq=SEQ, batch=batch)
    params = {}

    def P(name, dims, t=ht.Float(32)):
        if name not in params:
            params[name] = ht.ImageParam(t, dims, name)
        return params[name]

    xn = P("xn", 3)
    if kind == "mamba":
        out = gh._mamba(p, 0, xn, P)
    else:
        out = gh._attention(p, 2, xn, P)
    t, b, e = ht.Var("t"), ht.Var("b"), ht.Var("e")
    f = ht.Func("one_layer_out")
    if kind == "mamba":
        f[e, t, b] = out[e, t % p.chunk, t / p.chunk, b]
    else:
        f[e, t, b] = out[e, t, b]
    data = random_weights(p, 5)
    rng = np.random.default_rng(6)
    data["xn"] = rng.standard_normal((batch, SEQ, 64)).astype(np.float32)
    for name, ip in params.items():
        ip.set(ht.Buffer(torch.from_numpy(data[name])))
    W = {k: torch.from_numpy(v).double() for k, v in data.items()
         if v.dtype == np.float32}
    args = config_args(p)
    x = W["xn"]
    with torch.no_grad():
        want = ref._mamba(x, W.__getitem__, 0, args, torch.float64) \
            if kind == "mamba" else ref._attention(x, W.__getitem__, 2, args)
    return ht.Pipeline(f), params, p, data, want.numpy()


@pytest.mark.parametrize("kind", ["mamba", "attention"])
def test_one_mixer_against_the_reference(kind):
    """The chunked SSD against the step-by-step recurrence, and causal
    GQA (query head i reads KV head i / 2) against the reference's
    explicit mask."""
    pipe, _params, _p, _data, want = _one_layer(kind)
    got = pipe.realize([64, SEQ, 2], device="cpu").to_numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < LIMIT


def test_the_inter_chunk_update_takes_the_scan(monkeypatch):
    """Each mixer's `Sin` update is taken by `_try_scan` as a recurrence
    with a per-element coefficient: K2b's plain version on the CPU (one
    call a mixer), under one `ht.scan` span a mixer."""
    calls = []
    plain = scan_kernel.linear_scan_plain

    def spy(b, init, axis, backward, a_const=None, a=None):
        calls.append((tuple(b.shape), axis, backward, a_const, a is None))
        return plain(b, init, axis, backward, a_const, a)

    monkeypatch.setattr(scan_kernel, "linear_scan_plain", spy)
    app, _data = _app(2)
    app.pipeline.realize(app.output_sizes, device="cpu")
    rec = spans.recent()[-1]
    mixers = SMALL["layer_types"].count("mamba")
    assert rec["spans"]["ht.scan"]["count"] == mixers
    # the entering states of chunks 1-3: (batch, 3, heads, state, head dim)
    # scanned along the chunk axis, forward, with an array coefficient
    assert calls == [((2, 3, 4, 16, 16), 1, False, None, False)] * mixers


def test_a_seq_not_a_multiple_of_the_chunk_raises():
    with pytest.raises(ValueError, match="multiple of the Mamba-2 chunk"):
        get("granite_4_h_micro")(seq=SEQ + 8, batch=1, **SMALL)


def test_the_published_widths_build():
    """The app's defaults are the published model: 40 layers, attention
    at 5, 15, 25 and 35, and every weight at its published shape (3.19 B
    parameters); built, not realized."""
    app = get("granite_4_h_micro")(seq=4096, batch=1)
    p = app.params
    assert [i for i, k in enumerate(p.layer_types) if k == "attention"] == \
        [5, 15, 25, 35]
    shapes = p.weight_shapes()
    assert shapes["l0_in_proj"] == (8512, 2048)
    assert shapes["l0_conv_w"] == (4352, 4)
    assert shapes["l5_k"] == (8, 64, 2048)
    assert shapes["l0_mlp_in"] == (16384, 2048)
    n = sum(int(np.prod(s)) for s in shapes.values())
    assert 3.18e9 < n < 3.20e9
    assert [s.name for s in app.inputs] == ["tokens"] + list(shapes)
    assert app.output_sizes == [100352, 1]


def test_stage_kernel_sources_build_with_gxx_and_equal_eval_torch(tmp_path):
    """Every stage the stage kernel takes (all but the scan's update),
    its emitted source built by the host compiler, against eval_torch on
    the same arrays."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the emitted source")
    app, _data = _app(2)
    app.realize("cpu")
    calls = sk.stage_calls(app.pipeline, "cpu")
    declined = {c[0].name: c[3] for c in calls if isinstance(c[3], str)}
    assert declined == {f"l{i}_Sin": "update definitions"
                        for i in (0, 1, 3)}
    taken = [c for c in calls if not isinstance(c[3], str)]
    cu, so = tmp_path / "stages.cpp", tmp_path / "stages.so"
    cu.write_text(sk.translation_unit([c[3] for c in taken]))
    r = subprocess.run(
        [gxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
         "-ffp-contract=off", "-I", str(gk._CSRC), "-o", str(so), str(cu)],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[:4000]
    lib = ctypes.CDLL(str(so))
    for f, _box, before, spec, want in taken:
        fn = getattr(lib, f"host_{spec.symbol}")
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        arrays = [before[tid].arrays[vi] for tid, vi in spec.slots]
        out = torch.empty(tuple(reversed(spec.extents)), dtype=want.dtype)
        vals = sk.launch_args(spec, arrays, out)
        assert fn((ctypes.c_longlong * len(vals))(*vals)) == 0
        scale = max(want.double().abs().max().item(), 1e-30)
        err = (out.double() - want.double()).abs().max().item()
        assert err <= 1e-5 * scale, (f.name, err, scale)


def test_softplus_and_log1p_match_torch():
    """nn.softplus (log1p by Goldberg's correction) against torch's, over
    the range a Mamba-2 dt reaches and past the threshold."""
    from halide_tpu_torch.models import nn
    x = ht.Var("x")
    inp = ht.ImageParam(ht.Float(32), 1, "sp_in")
    f = ht.Func("sp_out")
    f[x] = nn.softplus(inp[x])
    v = torch.linspace(-30.0, 40.0, 7001)
    inp.set(ht.Buffer(v))
    got = ht.Pipeline(f).realize([v.numel()], device="cpu").data.double()
    want = torch.nn.functional.softplus(v.double())
    assert ((got - want).abs() / want).max() < 4e-7

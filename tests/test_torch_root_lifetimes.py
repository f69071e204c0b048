"""Root lifetimes (halide_tpu_torch/pipeline.py): a plan's run drops each
materialized Func's arrays after the last step that reads them, and keeps
the outputs, the memoized stages and the traced or dumped ones to its end.
`spans.counters()` gives `roots.released` (arrays dropped, since the
process started) and `roots.peak_bytes` (the largest bytes of stage
arrays live at once in the last run).

On the CPU: a chain's peak falls to two stages and its output is
unchanged; what is kept; resnet_50 at batch 1 the same, bit for bit, as a
run that drops nothing; the steps' order and their drops. On the card
(the `gpu` marker): a replayed plan with released roots equals its eager
realize, also after its input is bound to another tensor."""
import numpy as np
import pytest
import torch

import halide_tpu_torch as ht
from halide_tpu_torch import pipeline as pl
from halide_tpu_torch import plan_graph, spans

W, H, N = 40, 24, 6


def _chain(kind=None, tmp_path=None, inp=None):
    """N stages at root, each reading the one before (`inp`, where given)
    -> (pipeline, the Funcs, the input as numpy)."""
    x, y = ht.Var("x"), ht.Var("y")
    if inp is None:
        inp = ht.ImageParam(ht.Float(32), 2, "rl_in")
    fs = []
    prev = inp
    for k in range(N):
        f = ht.Func(f"rl_f{k}")
        f[x, y] = prev[x, y] * 2.0 + float(k)
        f.compute_root()
        fs.append(f)
        prev = f
    if kind == "memoized":
        fs[1].memoize()
    elif kind == "traced":
        fs[1].trace_realizations()
    elif kind == "debug_file":
        fs[1].debug_to_file(str(tmp_path / "rl_f1.npy"))
    data = np.random.default_rng(1).random((H, W), dtype=np.float32)
    inp.set(ht.Buffer(data))
    return ht.Pipeline(fs[-1]), fs, data


def _want(data):
    v = data.astype(np.float64)
    for k in range(N):
        v = v * 2.0 + k
    return v


def test_a_chain_keeps_two_stages_live_and_its_output():
    p, _fs, data = _chain()
    r0 = spans.counters()["roots.released"]
    out = p.realize([W, H], device="cpu").to_numpy()
    c = spans.counters()
    np.testing.assert_allclose(out, _want(data), rtol=1e-6)
    # each stage but the output dropped after its reader's step
    assert c["roots.released"] - r0 == N - 1
    assert c["roots.peak_bytes"] == 2 * W * H * 4
    # the plan records one drop a stage but the output
    run = list(p._plan_cache.values())[-1]
    assert sum(len(d) for d in run.planned["release"]) == N - 1


def test_the_drops_follow_the_last_reader():
    """A stage read by two later ones goes after the second."""
    x, y = ht.Var("x"), ht.Var("y")
    inp = ht.ImageParam(ht.Float(32), 2, "rl_in2")
    a, b, c, d = (ht.Func(f"rl_{n}") for n in "abcd")
    a[x, y] = inp[x, y] + 1.0
    b[x, y] = a[x, y] * 2.0
    c[x, y] = b[x, y] - 3.0
    d[x, y] = c[x, y] + a[x, y]            # a's last reader
    for f in (a, b, c):
        f.compute_root()
    inp.set(ht.Buffer(np.ones((H, W), np.float32)))
    p = ht.Pipeline(d)
    out = p.realize([W, H], device="cpu").to_numpy()
    np.testing.assert_array_equal(out, np.full((H, W), 3.0, np.float32))
    run = list(p._plan_cache.values())[-1]
    names = [[f.name for f in [s[1]] + s[2]] for s in run.planned["steps"]]
    assert names == [["rl_a"], ["rl_b"], ["rl_c"], ["rl_d"]]
    by_id = {id(f): f.name for f in (a, b, c, d)}
    drops = [sorted(by_id[i] for i in ids) for ids in run.planned["release"]]
    assert drops == [[], [], ["rl_b"], ["rl_a", "rl_c"]]


@pytest.mark.parametrize("kind", ["memoized", "traced", "debug_file"])
def test_memoized_traced_and_dumped_stages_are_kept(kind, tmp_path):
    p, fs, data = _chain(kind, tmp_path)
    if kind == "traced":
        from halide_tpu_torch.trace import Trace
        p.trace = Trace()
    out = p.realize([W, H], device="cpu").to_numpy()
    np.testing.assert_allclose(out, _want(data), rtol=1e-6)
    run = list(p._plan_cache.values())[-1]
    dropped = {i for ids in run.planned["release"] for i in ids}
    assert id(fs[1]) not in dropped and id(fs[-1]) not in dropped
    assert id(fs[0]) in dropped and id(fs[2]) in dropped


def test_the_outputs_of_a_two_output_pipeline_are_kept():
    x, y = ht.Var("x"), ht.Var("y")
    inp = ht.ImageParam(ht.Float(32), 2, "rl_in3")
    a, b, c = ht.Func("rl_2a"), ht.Func("rl_2b"), ht.Func("rl_2c")
    a[x, y] = inp[x, y] * 3.0
    b[x, y] = a[x, y] + 1.0
    c[x, y] = b[x, y] * a[x, y]
    a.compute_root()
    inp.set(ht.Buffer(np.full((H, W), 2.0, np.float32)))
    p = ht.Pipeline([b, c])
    ob, oc = p.realize([W, H], device="cpu")
    np.testing.assert_array_equal(ob.to_numpy(), np.full((H, W), 7.0))
    np.testing.assert_array_equal(oc.to_numpy(), np.full((H, W), 42.0))
    run = list(p._plan_cache.values())[-1]
    dropped = {i for ids in run.planned["release"] for i in ids}
    assert dropped == {id(a)}


def test_resnet_50_at_batch_1_as_before(monkeypatch):
    """resnet_50 (one stage of each block, at 64x64) with its roots
    dropped gives the output of a run that keeps every stage, bit for
    bit, at a lower peak."""
    from halide_tpu_torch.apps import get
    torch.set_num_threads(1)
    outs, peaks = [], []
    for drop in (False, True):
        if not drop:
            monkeypatch.setattr(pl, "_last_readers",
                                lambda steps, g, keep: [[] for _ in steps])
        else:
            monkeypatch.undo()
        app = get("resnet_50")(layers=(1, 1, 1, 1), width=8, classes=10,
                               image=64, batch=1)
        app.bind(app.make_inputs(2), "cpu")
        outs.append(app.realize("cpu").to_numpy())
        peaks.append(spans.counters()["roots.peak_bytes"])
    np.testing.assert_array_equal(outs[0], outs[1])
    assert peaks[1] < peaks[0] / 2
    want = app.reference(**app.make_inputs(2))
    np.testing.assert_allclose(outs[1], want, rtol=5e-3, atol=1e-5)


@pytest.mark.gpu
def test_a_replayed_plan_with_released_roots_equals_its_eager_realize():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p, _fs, data = _chain()
    eager = p.realize([W, H]).to_numpy()
    c0 = plan_graph.replays
    for _ in range(4):
        got = p.realize([W, H]).to_numpy()
        np.testing.assert_array_equal(got, eager)
    assert plan_graph.replays >= c0 + 3
    assert spans.counters()["roots.peak_bytes"] == 2 * W * H * 4
    np.testing.assert_allclose(eager, _want(data), rtol=1e-6)


@pytest.mark.gpu
def test_a_replay_after_the_input_is_bound_anew_equals_its_eager_realize():
    """Bound to tensor A up to the capture and to tensor B after it, the
    replay reads B: it equals an eager realize of B."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    inp = ht.ImageParam(ht.Float(32), 2, "rl_rebind")
    p, _fs, a = _chain(inp=inp)
    c0 = plan_graph.replays
    for _ in range(4):
        got = p.realize([W, H]).to_numpy()
    assert plan_graph.replays >= c0 + 1
    np.testing.assert_allclose(got, _want(a), rtol=1e-6)
    b = np.random.default_rng(2).random((H, W), dtype=np.float32)
    inp.set(ht.Buffer(b))
    r0 = plan_graph.replays
    got = p.realize([W, H]).to_numpy()
    assert plan_graph.replays == r0 + 1
    # the same chain on its own input, bound to B: its first realize is
    # eager
    q_inp = ht.ImageParam(ht.Float(32), 2, "rl_eager")
    q, _gs, _d = _chain(inp=q_inp)
    q_inp.set(ht.Buffer(b))
    eager = q.realize([W, H]).to_numpy()
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_allclose(got, _want(b), rtol=1e-6)

"""A planned realize replayed as one CUDA graph (halide_tpu_torch/
plan_graph.py). On the CPU: which plans and calls may replay, that a CPU
realize never captures, a hit that cannot replay runs eager and is counted,
a replay's copies in and out, the bound on the graphs kept, and the span
and counters. On the card (the `gpu` marker): camera_pipe and
local_laplacian replayed frame after frame, each kept output bit for bit an
eager realize's, the counters, a changed Param, a `dst` realize, plans
taking turns within the bound and a capture that raises. The card's tests
import no JAX."""
import numpy as np
import pytest
import torch

import halide_tpu_torch as ht
from halide_tpu_torch import pipeline as pl
from halide_tpu_torch import plan_graph, spans

W, H = 48, 32


def _pipeline(kind=None, tmp_path=None):
    """pg_pre (stored at root) read by pg_out, with `kind`'s feature; ->
    (pipeline, sizes)."""
    x, y = ht.Var("x"), ht.Var("y")
    inp = ht.ImageParam(ht.Float(32), 2, "pg_in")
    pre, out = ht.Func("pg_pre"), ht.Func("pg_out")
    if kind == "extern":
        pre.define_extern("pg_pre", lambda a: a * 2.0, [inp],
                          ht.Float(32), 2)
    else:
        pre[x, y] = inp[x, y] * 2.0
        pre.compute_root()
    v = pre[x, y] + pre[x + 1, y]
    if kind == "print":
        v = ht.print_expr(v, "pg")
    elif kind == "print_when":
        v = ht.print_when(v > 1e9, v, "pg")
    elif kind == "require":
        v = ht.require(v > -1.0, v, "pg")
    out[x, y] = v
    if kind == "traced":
        pre.trace_stores()
    elif kind == "memoized":
        pre.memoize()
    elif kind == "debug_file":
        pre.debug_to_file(str(tmp_path / "pg_pre.npy"))
    elif kind == "distributed":
        out.distribute(y)
    rng = np.random.default_rng(3)
    inp.set(ht.Buffer(rng.random((H, W), dtype=np.float32)))
    p = ht.Pipeline(out)
    if kind == "trace_installed":
        from halide_tpu_torch.trace import Trace
        p.trace = Trace()
    return p, [W - 1, H]


def test_a_plain_pipeline_may_replay():
    p, _sizes = _pipeline()
    assert plan_graph.why_not(p, pl.gather_graph(p.outputs)) is None


@pytest.mark.parametrize("kind,says", [
    ("traced", "pg_pre is traced"),
    ("trace_installed", "a trace is installed"),
    ("memoized", "pg_pre is memoized"),
    ("extern", "pg_pre is an extern stage"),
    ("print", "pg_out calls print"),
    ("print_when", "pg_out calls print_when"),
    ("require", "pg_out calls require"),
    ("debug_file", "pg_pre dumps to a file"),
    ("distributed", "pg_out has a distribute record")])
def test_a_plan_that_goes_to_the_host_may_not_replay(kind, says, tmp_path):
    p, _sizes = _pipeline(kind, tmp_path)
    assert plan_graph.why_not(p, pl.gather_graph(p.outputs)) == says


def test_a_call_on_the_cpu_may_not_replay():
    t = torch.zeros(4)
    for dev in ("cpu", "cuda"):
        assert plan_graph.why_not_now(torch.device(dev), [t]) == \
            "an input is not on the card"


def _graph_counters():
    c = spans.counters()
    return {k: c[k] for k in ("plan_graph.captures", "plan_graph.replays",
                              "plan_graph.fallbacks")}


def test_a_cpu_realize_never_captures():
    p, sizes = _pipeline()
    before = _graph_counters()
    outs = [p.realize(sizes, device="cpu").to_numpy() for _ in range(4)]
    assert _graph_counters() == before
    (run,) = p._plan_cache.values()
    assert run.replays == {}
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    recs = spans.recent()[-4:]
    assert all(r["spans"]["ht.replay"]["count"] == 0 for r in recs)


def test_a_hit_on_the_card_that_cannot_replay_runs_eager_and_counts():
    """`run` on a CPU plan told it is on the card: its first call plans,
    eager and uncounted; each later one finds the inputs off the card and
    runs eager, counted as a fallback; a plan that goes to the host keeps
    its reason."""
    cuda = torch.device("cuda")
    for kind, says in ((None, "an input is not on the card"),
                       ("traced", "pg_pre is traced")):
        p, sizes = _pipeline(kind)
        run, _c, inputs, presets, _r = p._prepare(sizes, None,
                                                  torch.device("cpu"))
        f0 = plan_graph.fallbacks
        want = plan_graph.run(p, run, inputs, presets, True, cuda)
        assert plan_graph.fallbacks == f0 and run.replays == {}
        for k in range(1, 3):
            got = plan_graph.run(p, run, inputs, presets, True, cuda)
            assert plan_graph.fallbacks == f0 + k
            assert plan_graph.last_fallback == says
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert run.replays == {True: 0 if kind is None else says}


class _Graph:
    """A stand-in for a captured CUDA graph on the CPU: its replay
    computes the outputs from the static inputs."""

    def __init__(self, static, out):
        self.static, self.out = static, out
        self.replays = 0

    def replay(self):
        self.out.copy_(torch.nn.functional.pad(self.static[0] * 3,
                                               (0, 2, 0, 1)))
        self.replays += 1


def test_a_replay_copies_in_and_gives_fresh_outputs_of_eager_strides():
    static = [torch.zeros(5, 4)]
    full = torch.zeros(6, 6)           # the output's box, larger than asked
    view = full[:5, 1:5]               # the slice an eager realize returns
    g = _Graph(static, full)
    cap = plan_graph.Captured(g, static, ((view,),), (0, {}, 0))
    r0 = plan_graph.replays
    kept = []
    for k in range(3):
        a = torch.arange(20.0).reshape(5, 4) + k
        ((o,),) = plan_graph._replay(cap, [a])
        assert (o.shape, o.stride(), o.dtype) == \
            (view.shape, view.stride(), view.dtype)
        assert o.untyped_storage().data_ptr() != \
            full.untyped_storage().data_ptr()
        kept.append((a, o))
    for a, o in kept:                   # no kept frame aliases another
        torch.testing.assert_close(o, torch.nn.functional.pad(
            a * 3, (0, 2, 0, 1))[:5, 1:5], rtol=0, atol=0)
    assert plan_graph.replays == r0 + 3 and g.replays == 3
    # the static input bound again: nothing is copied (an in-place copy
    # would move the version counter the view shares)
    version = static[0]._version
    ((o,),) = plan_graph._replay(cap, [static[0].view(5, 4)])
    assert static[0]._version == version
    torch.testing.assert_close(o, kept[-1][1], rtol=0, atol=0)


def _grouped():
    """pg_gpre (stored at root) read by one K1 group: pg_gy tiled, pg_gx
    computed at its tiles; -> (pipeline, sizes)."""
    x, y = ht.Var("x"), ht.Var("y")
    xo, yo, xi, yi = ht.Var("xo"), ht.Var("yo"), ht.Var("xi"), ht.Var("yi")
    inp = ht.ImageParam(ht.Float(32), 2, "pg_gin")
    pre, gx, gy = ht.Func("pg_gpre"), ht.Func("pg_gx"), ht.Func("pg_gy")
    pre[x, y] = inp[x, y] * 2.0
    gx[x, y] = pre[x, y] + pre[x + 1, y]
    gy[x, y] = gx[x, y] + gx[x, y + 1]
    pre.compute_root()
    gy.tile(x, y, xo, yo, xi, yi, 16, 8)
    gx.compute_at(gy, xo)
    rng = np.random.default_rng(4)
    inp.set(ht.Buffer(rng.random((H, W), dtype=np.float32)))
    return ht.Pipeline(gy), [W - 1, H - 1]


class _Replayed:
    """A stand-in for a captured graph whose outputs are already in
    place."""

    def replay(self):
        pass


def test_a_replay_counts_its_launches_and_leaves_k1s_records(monkeypatch):
    """The replay branch of `run` on the CPU, with a stand-in graph: the
    launches the capture counted are counted again, K1's records read the
    group's plan as an eager realize leaves them, and the outputs are
    fresh copies."""
    from halide_tpu_torch.ops import group_kernel, scan_kernel
    p, sizes = _grouped()
    cpu = torch.device("cpu")
    p.realize(sizes, device="cpu")                  # plans the group
    run, _c, inputs, presets, _r = p._prepare(sizes, None, cpu)
    outs = run(inputs, presets, True)
    (gp,) = [g for g in run.planned["groups"].values() if g]
    run.replays[True] = plan_graph.Captured(
        _Replayed(), [a.clone() for a in inputs], outs,
        (1, {k: 0 for k in scan_kernel.launches}, 0))
    monkeypatch.setattr(plan_graph, "why_not_now", lambda dev, a: None)
    group_kernel.last_plan = None
    group_kernel.plans_by_name.pop("pg_gy", None)
    group_kernel.rejects_by_name["pg_gy"] = "stale"
    n0, r0 = group_kernel.launches, plan_graph.replays
    got = plan_graph.run(p, run, inputs, presets, True, torch.device("cuda"))
    assert group_kernel.launches == n0 + 1
    assert plan_graph.replays == r0 + 1
    assert group_kernel.last_plan is gp.recorded
    assert group_kernel.plans_by_name["pg_gy"] is gp.recorded
    assert "pg_gy" not in group_kernel.rejects_by_name
    ((o,),) = got
    assert o.untyped_storage().data_ptr() != \
        outs[0][0].untyped_storage().data_ptr()
    torch.testing.assert_close(o, outs[0][0], rtol=0, atol=0)


def test_the_replay_span_and_the_counters():
    assert "ht.replay" in spans.KINDS
    assert spans.KINDS[spans.REPLAY] == "ht.replay"
    c = spans.counters()
    assert c["plan_graph.captures"] == plan_graph.captures
    assert c["plan_graph.replays"] == plan_graph.replays
    assert c["plan_graph.fallbacks"] == plan_graph.fallbacks


def test_a_call_that_plans_or_exports_the_groups_may_not_replay(
        monkeypatch):
    """A realize under `group_kernel.planning` computes no group, and one
    under `export_ops.export_mode` calls the exported op: neither may be
    captured or replayed."""
    from halide_tpu_torch.ops import export_ops, group_kernel
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    cuda = torch.device("cuda")
    assert plan_graph.why_not_now(cuda, []) is None
    with group_kernel.planning(lambda *_a: None):
        assert plan_graph.why_not_now(cuda, []) == \
            "the groups are planned, not computed"
    with export_ops.export_mode():
        assert plan_graph.why_not_now(cuda, []) == \
            "a program is being exported"
    assert plan_graph.why_not_now(cuda, []) is None


class _Memory:
    total_memory = 100


def _keep(monkeypatch, nbytes):
    """Graphs of `nbytes` each, kept oldest first, each on a plan's
    `replays` of its own; -> (graphs, their plans' `replays`)."""
    monkeypatch.setattr(plan_graph, "_kept", [])
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _Memory())
    owners = [{} for _ in nbytes]
    caps = []
    for owner, n in zip(owners, nbytes):
        owner[True] = c = plan_graph.Captured(_Replayed(), [], (), (0, {}, 0),
                                              owner, True, n)
        plan_graph._kept.append(__import__("weakref").ref(c))
        caps.append(c)
    return caps, owners


def test_the_graphs_kept_are_bounded_in_number(monkeypatch):
    """Before a capture the least recently replayed graphs are dropped
    until fewer than `_KEEP` are kept; a dropped graph's plan runs eager
    from then on, and the graph is freed."""
    import weakref
    keep = plan_graph._KEEP
    caps, owners = _keep(monkeypatch, [1] * (keep + 2))
    plan_graph._touch(caps[0])          # replayed last: kept
    assert plan_graph.kept()[-1] is caps[0]
    refs = [weakref.ref(c) for c in caps]
    del caps
    plan_graph._make_room(torch.device("cuda"))
    kept = plan_graph.kept()
    assert len(kept) == keep - 1
    assert kept == [r() for r in refs[4:]] + [refs[0]()]
    for k in (1, 2, 3):
        assert owners[k][True] == plan_graph.DROPPED
        assert refs[k]() is None
    assert all(isinstance(o[True], plan_graph.Captured)
               for o in owners[4:] + owners[:1])


def test_the_graphs_kept_are_bounded_in_memory(monkeypatch):
    """The graphs kept beside a new capture hold at most `_KEEP_SHARE` of
    the card's memory (100 bytes here): the oldest go until they do."""
    monkeypatch.setattr(plan_graph, "_KEEP_SHARE", 0.25)
    _caps, owners = _keep(monkeypatch, [20, 10, 10, 10])
    del _caps
    plan_graph._make_room(torch.device("cuda"))
    assert [o[True] == plan_graph.DROPPED for o in owners] == \
        [True, True, False, False]
    assert [c.nbytes for c in plan_graph.kept()] == [10, 10]
    # within the bound: nothing goes
    plan_graph._make_room(torch.device("cuda"))
    assert len(plan_graph.kept()) == 2


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _app(name):
    from halide_tpu_torch.apps import get
    if name == "camera_pipe":
        return get(name)(out_width=512, out_height=256, kernel=True,
                         tile=(256, 64))
    return get(name)(512, 256)


def _same(a, b):
    assert (a.shape, a.stride(), a.dtype) == (b.shape, b.stride(), b.dtype)
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["camera_pipe", "local_laplacian"])
def test_frames_replay_bit_for_bit_on_the_card(name):
    from halide_tpu_torch.ops import group_kernel
    dev = _card()
    app = _app(name)
    c0 = _graph_counters()
    kept, k1 = [], []
    for seed in range(4):
        data = app.make_inputs(seed)
        app.bind(data)
        n0 = group_kernel.launches
        group_kernel.last_plan = None
        kept.append((data, app.realize().data))
        torch.cuda.synchronize()
        k1.append(group_kernel.launches - n0)
    c1 = _graph_counters()
    hit = plan_graph._CAPTURE_HIT
    assert c1["plan_graph.captures"] - c0["plan_graph.captures"] == 1
    assert c1["plan_graph.replays"] - c0["plan_graph.replays"] == 4 - hit
    assert c1["plan_graph.fallbacks"] == c0["plan_graph.fallbacks"]
    assert k1 == [1, 1, 1, 1]
    recs = spans.recent()[-4:]
    assert [r["spans"]["ht.replay"]["count"] for r in recs] == \
        [0] * hit + [1] * (4 - hit)
    # the replays left K1's records as the eager realize did
    assert group_kernel.last_plan is not None and group_kernel.last_plan \
        is group_kernel.plans_by_name[app.pipeline.outputs[0].name]
    assert recs[3]["spans"]["ht.stage"]["count"] == 0
    ptrs = {o.untyped_storage().data_ptr() for _d, o in kept}
    assert len(ptrs) == 4
    for data, out in kept:
        app.bind(data)
        # a new Pipeline over the same outputs: a plan miss, eager
        eager = ht.Pipeline(app.pipeline.outputs).realize(
            app.output_sizes, device=dev).data
        _same(out, eager)
    # a dst realize after the capture: filled as an eager one
    dst = ht.Buffer(type=app.pipeline.outputs[0].output_type(0),
                    sizes=app.output_sizes)
    r0 = plan_graph.replays
    app.pipeline.realize(dst=dst, device=dev)
    app.pipeline.realize(dst=dst, device=dev)
    assert plan_graph.replays > r0
    assert torch.equal(dst.data, eager)


@pytest.mark.gpu
def test_a_changed_param_gives_a_new_plan_and_capture():
    dev = _card()
    x, y = ht.Var("x"), ht.Var("y")
    inp = ht.ImageParam(ht.Float(32), 2, "pg_pin")
    gain = ht.Param(ht.Float(32), "pg_gain")
    f = ht.Func("pg_pf")
    f[x, y] = inp[x, y] * gain + inp[x + 1, y]
    p = ht.Pipeline(f)
    a = torch.rand(64, 65, device=dev)
    inp.set(ht.Buffer(a))
    c0 = plan_graph.captures
    for g in (2.0, 3.0):
        gain.set(g)
        outs = [p.realize([64, 64], device=dev).data
                for _ in range(plan_graph._CAPTURE_HIT + 2)]
        want = a[:, :64] * g + a[:, 1:]
        for o in outs:
            torch.testing.assert_close(o, want)
    assert plan_graph.captures - c0 == 2
    assert len(p._plan_cache) == 2


@pytest.mark.gpu
def test_a_capture_first_frees_dead_plans(monkeypatch):
    """A Pipeline lives in a reference cycle with its plans: where the
    graphs kept reach their bound, the next capture collects a dropped
    one, and its graph with it, before it drops a live plan's."""
    import weakref
    dev = _card()
    monkeypatch.setattr(plan_graph, "_KEEP", 2)
    p, sizes = _pipeline()
    live, _sizes = _pipeline()
    for _ in range(plan_graph._CAPTURE_HIT + 1):
        live.realize(sizes, device=dev)
        p.realize(sizes, device=dev)
    (run,) = p._plan_cache.values()
    assert isinstance(run.replays[True], plan_graph.Captured)
    dead = weakref.ref(p)
    del p, run
    q, sizes = _pipeline()
    c0 = plan_graph.captures
    for _ in range(plan_graph._CAPTURE_HIT + 1):
        q.realize(sizes, device=dev)
    assert plan_graph.captures == c0 + 1
    assert dead() is None
    (run,) = live._plan_cache.values()
    assert isinstance(run.replays[True], plan_graph.Captured)


@pytest.mark.gpu
def test_the_graphs_of_plans_taking_turns_stay_bounded():
    """Plans of one Pipeline at 6 sizes, realized in turns: at most
    `_KEEP` - 1 graphs beside the newest, the card's reserved memory no
    higher after the last rounds than after the first ones, a dropped
    plan eager and right from then on."""
    dev = _card()
    p, _sizes = _pipeline()
    sizes = [[W - 1 - k, H - k] for k in range(6)]
    want = {k: p.realize(s, device="cpu").data for k, s in enumerate(sizes)}
    reserved = []
    for _round in range(plan_graph._CAPTURE_HIT + 4):
        for k, s in enumerate(sizes):
            got = p.realize(s, device=dev).data
            torch.testing.assert_close(got.cpu(), want[k], rtol=0, atol=0)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(dev))
        assert len(plan_graph.kept()) <= plan_graph._KEEP
    states = [r.replays[True] for r in p._plan_cache.values()
              if r.planned.get("boxes") is not None and True in r.replays]
    assert sum(isinstance(st, plan_graph.Captured) for st in states) \
        <= plan_graph._KEEP
    assert states.count(plan_graph.DROPPED) >= 6 - plan_graph._KEEP
    assert reserved[-1] <= reserved[-3]


@pytest.mark.gpu
def test_a_capture_that_raises_leaves_the_plan_eager(monkeypatch):
    """A stage that waits for the card inside the capture: the capture
    raises, that realize and every later one run eager and right, and the
    next plan captures as before."""
    dev = _card()
    before, sizes = _pipeline()
    for _ in range(plan_graph._CAPTURE_HIT + 2):
        before.realize(sizes, device=dev)
    p, sizes = _pipeline()
    want = p.realize(sizes, device="cpu").data
    evaluate = pl._evaluate_func

    def waits(f, box, ctx0):
        torch.cuda.synchronize()
        return evaluate(f, box, ctx0)
    monkeypatch.setattr(pl, "_evaluate_func", waits)
    f0, c0 = plan_graph.fallbacks, plan_graph.captures
    for _ in range(plan_graph._CAPTURE_HIT + 2):
        got = p.realize(sizes, device=dev).data
        torch.testing.assert_close(got.cpu(), want)
    assert plan_graph.captures == c0
    assert plan_graph.fallbacks == f0 + 2
    assert plan_graph.last_fallback.startswith("the capture raised"), \
        plan_graph.last_fallback
    (run,) = [r for r in p._plan_cache.values() if r.replays]
    assert isinstance(run.replays[True], str)
    monkeypatch.setattr(pl, "_evaluate_func", evaluate)
    q, sizes = _pipeline()
    for _ in range(plan_graph._CAPTURE_HIT + 2):
        got = q.realize(sizes, device=dev).data
        torch.testing.assert_close(got.cpu(), want)
    assert plan_graph.captures == c0 + 1, plan_graph.last_fallback
    # the plan captured before the failure still replays right
    r0 = plan_graph.replays
    got = before.realize(sizes, device=dev).data
    assert plan_graph.replays == r0 + 1
    torch.testing.assert_close(got.cpu(), want)

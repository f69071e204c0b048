"""Members stored at a loop that encloses their compute loop
(`store_at(f, yo)` or `store_root()`) in the stencil-group kernel (K1). The
reference and the JAX package slide such a member's window: they keep its
buffer across the steps of a loop and compute only the new band at each
(`pallas_group.py:1229-1307`, `:1476-1521`). The port computes it whole
in every sub-tile, as any other member, because the carry measured slower
on the H100 (PERF.md): its store level changes no plan.

On the CPU: the carry cases of tests/test_pallas.py, a member chain,
linear_blur and stencil_chain's slide branch planned with nothing carried,
one sub-tile a block, their outputs against the JAX package's (Pallas in
interpret mode) and numpy, bit for bit (integer pipelines); the emitted
source built with g++ against the plain version and numpy, at the planned
sub-tile and at sub-tiles whose step is below the members' overlap on
ragged extents (the last sub-tile shifted inwards); and each group's plan
and source the same with and without its members' store levels. The card's
own copies and barriers run only on the card (the tests marked gpu)."""

import numpy as np
import pytest
import torch

import halide_tpu_torch as ht
from halide_tpu_torch.ops import group_kernel as gk
from test_torch_group_kernel import _host_build


def _realize_port(pipe, sizes):
    before = sum(gk.rejects.values())
    gk.last_plan = None
    out = pipe.realize(sizes, device="cpu").to_numpy()
    assert sum(gk.rejects.values()) == before, dict(gk.rejects)
    assert gk.last_plan is not None
    return out, gk.last_plan


def _realize_jax(pipe, sizes):
    from halide_tpu.ops import pallas_group as pg
    pg._last_plan = None
    out = np.asarray(pipe.realize(sizes, jit=False).to_numpy())
    assert pg._last_plan is not None
    return out, pg._last_plan


# ---------------------------------------------------------------------------
# the carry cases of tests/test_pallas.py, in both packages
# ---------------------------------------------------------------------------

def _box3(m, img, case, device="cpu"):
    """The 3-tap box blurs of tests/test_pallas.py's carry cases (`:361`,
    `:391`, `:473`): a member and a consumer, u16. -> (consumer, sizes)."""
    x, y = m.Var("x"), m.Var("y")
    xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
    inp = m.Buffer(torch.from_numpy(img).to(device) if m is ht else img)
    H, W = img.shape
    if case == "x_carry":          # :361, the member carried along x
        bx, by = m.Func("sw_bx"), m.Func("sw_by")
        bx[x, y] = (inp[x, y] + inp[x, y + 1] + inp[x, y + 2]) / 3
        by[x, y] = (bx[x, y] + bx[x + 1, y] + bx[x + 2, y]) / 3
        by.tile(x, y, xo, yo, xi, yi, 64, 16).vectorize(xi).parallel(yo)
        bx.compute_at(by, xo).store_at(by, yo)
    elif case == "inner_level":    # :391, stored where it is computed
        bx, by = m.Func("swn_bx"), m.Func("swn_by")
        bx[x, y] = (inp[x, y] + inp[x + 1, y] + inp[x + 2, y]) / 3
        by[x, y] = (bx[x, y] + bx[x, y + 1] + bx[x, y + 2]) / 3
        by.tile(x, y, xo, yo, xi, yi, 64, 16).vectorize(xi).parallel(yo)
        bx.compute_at(by, xo).store_at(by, xo)
    else:                          # :473, carried down the band walk
        bx, by = m.Func("ys_bh"), m.Func("ys_bv")
        bx[x, y] = (inp[x, y] + inp[x + 1, y] + inp[x + 2, y]) / 3
        by[x, y] = (bx[x, y] + bx[x, y + 1] + bx[x, y + 2]) / 3
        by.tile(x, y, xo, yo, xi, yi, W - 2, 128).vectorize(xi) \
            .parallel(yo)
        bx.compute_at(by, xo).store_root()
    return by, [W - 2, H - 2]


# case -> (W, H, seed, the carried members)
BOX3_CASES = {
    "x_carry": (256, 64, 11, ["sw_bx"]),
    "inner_level": (256, 64, 12, []),
    "y_carry": (256, 1026, 22, ["ys_bh"]),
}


def _box3_golden(img, case):
    a = img.astype(np.uint16)
    if case == "x_carry":
        r = (a[:-2] + a[1:-1] + a[2:]) // 3
        return (r[:, :-2] + r[:, 1:-1] + r[:, 2:]) // 3
    r = (a[:, :-2] + a[:, 1:-1] + a[:, 2:]) // 3
    return (r[:-2] + r[1:-1] + r[2:]) // 3


def _box3_input(case):
    W, H, seed, _ = BOX3_CASES[case]
    return np.random.default_rng(seed).integers(0, 1 << 14, (H, W),
                                                np.uint16)


@pytest.mark.parametrize("case", sorted(BOX3_CASES))
def test_carry_plan_and_values_match_jax(case, monkeypatch):
    """The JAX planner carries the case's members (along x across the
    tiles of a row; y down its band split, with its double-buffered DMA
    forced as its test does); the port carries none and computes one
    sub-tile a block, and the outputs are bit for bit the JAX package's
    and numpy's."""
    import halide_tpu as hl
    img = _box3_input(case)
    by, sizes = _box3(ht, img, case)
    out, rec = _realize_port(ht.Pipeline(by), sizes)
    if case == "y_carry":
        monkeypatch.setenv("HALIDE_TPU_FORCE_PIPELINE", "1")
    jby, _ = _box3(hl, img, case)
    ref, jrec = _realize_jax(jby, sizes)
    assert jrec["sliding"] == BOX3_CASES[case][3], jrec
    assert "sliding" not in rec and rec["grid"] == rec["sub_tiles"], rec
    assert rec["band_walk"] == jrec["band_split"] == (case == "y_carry")
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, _box3_golden(img, case))


@pytest.mark.parametrize("case", ["x_carry", "y_carry"])
def test_carry_cases_source_on_host(case, tmp_path):
    """The g++ build of the planned launch, whose member the JAX planner
    carries, equals the plain version and numpy bit for bit."""
    img = _box3_input(case)
    by, sizes = _box3(ht, img, case)
    pipe = ht.Pipeline(by)
    out, _rec = _realize_port(pipe, sizes)
    gold = _box3_golden(img, case)
    np.testing.assert_array_equal(out, gold)
    plan, inputs, rmins, params, _r = gk.group_call(pipe, "cpu")
    host = torch.zeros(tuple(reversed(plan.extents)), dtype=torch.uint16)
    assert _host_build(plan, tmp_path)(*gk.launch_args(plan, inputs, rmins,
                                                       host)) == 0
    plain = gk.run_plain(plan, inputs, rmins, params, torch.device("cpu"))
    np.testing.assert_array_equal(host.numpy(), plain.numpy())
    np.testing.assert_array_equal(host.numpy(), gold)


# ---------------------------------------------------------------------------
# a member chain stored at the row loop (x) or at root (y), at narrow
# sub-tiles: overlaps larger than the step, ragged extents (the last
# sub-tile shifted inwards)
# ---------------------------------------------------------------------------

def _chain(m, a, axis, device="cpu"):
    """inp (edge-clamped, i32) -> c0 -> c1 -> c2, each reading its producer
    at (x - 1, y), (x + 2, y + 1) and (x, y - 1), -> out (tiled) reading c2
    at x and x + 1. The JAX planner carries all three along x (overlaps 7,
    4 and 1), and c0 and c1 along y (4 and 2), c2 being read at y alone.
    -> (pipeline, sizes)."""
    x, y = m.Var("x"), m.Var("y")
    xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
    inp = m.ImageParam(m.Int(32), 2, "inp")
    prev, chain = m.repeat_edge(inp), []
    for k in range(3):
        g = m.Func(f"c{k}")
        g[x, y] = prev[x - 1, y] + prev[x + 2, y + 1] * 3 - prev[x, y - 1]
        chain.append(g)
        prev = g
    out = m.Func("out")
    out[x, y] = prev[x, y] + prev[x + 1, y]
    H, W = a.shape
    if axis == "x":
        out.tile(x, y, xo, yo, xi, yi, 16, 8).parallel(yo)
    else:
        out.tile(x, y, xo, yo, xi, yi, W, 8).parallel(yo)
    for g in chain:
        g.compute_at(out, xo)
        if axis == "x":
            g.store_at(out, yo)
        else:
            g.store_root()
    inp.set(torch.from_numpy(a).to(device) if m is ht else a)
    return m.Pipeline(out), [W, H]


def _chain_input(axis):
    shape = (21, 70) if axis == "x" else (69, 30)      # (H, W): ragged
    return np.random.default_rng(7).integers(-300, 300, shape) \
        .astype(np.int32)


def _chain_golden(a):
    H, W = a.shape
    pad = 12
    cur = np.pad(a.astype(np.int64), pad, mode="edge")     # origin -pad

    def at(v, dx, dy):
        return np.roll(v, (-dy, -dx), (0, 1))
    for _k in range(3):
        cur = at(cur, -1, 0) + at(cur, 2, 1) * 3 - at(cur, 0, -1)
    o = cur + at(cur, 1, 0)
    return o[pad:pad + H, pad:pad + W].astype(np.int32)


# axis -> the sub-tiles the plan is forced to: steps below the overlap
CHAIN_SUBS = {"x": [(4, 8), (6, 4)], "y": [(8, 2), (30, 2)]}


@pytest.mark.parametrize("axis", ["x", "y"])
def test_chain_carry_matches_jax(axis):
    """The planner's own plan of the chain, whose members the JAX planner
    carries: the port carries none, and the outputs equal the JAX
    package's and numpy's."""
    import halide_tpu as hl
    a = _chain_input(axis)
    pipe, sizes = _chain(ht, a, axis)
    out, rec = _realize_port(pipe, sizes)
    ref, jrec = _realize_jax(_chain(hl, a, axis)[0], sizes)
    assert jrec["sliding"] == (["c0", "c1", "c2"] if axis == "x"
                               else ["c0", "c1"]), jrec
    assert "sliding" not in rec and rec["grid"] == rec["sub_tiles"], rec
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, _chain_golden(a))


@pytest.mark.parametrize("axis", ["x", "y"])
def test_chain_carry_source_on_host(axis, tmp_path):
    """At sub-tiles whose step is below the members' overlap, on a ragged
    extent: the g++ build and the plain version equal numpy bit for
    bit."""
    a = _chain_input(axis)
    pipe, sizes = _chain(ht, a, axis)
    _realize_port(pipe, sizes)
    gold = _chain_golden(a)
    calls = gk.group_calls(pipe, "cpu", lambda p: [
        dict(sub_tile=s, threads=128) for s in CHAIN_SUBS[axis]])
    assert len(calls) == len(CHAIN_SUBS[axis])
    for plan, inputs, rmins, params, _r in calls:
        rec = plan.record()
        step = plan.sx if axis == "x" else plan.sy
        j = "xy".index(axis)
        # the members' overlap with the next sub-tile along the axis
        over = [m.dims[j][3] - step for m in plan.members]
        assert max(over) > step, rec
        n = plan.ncx if axis == "x" else plan.ncy
        ext = plan.extents[plan.xi if axis == "x" else plan.yi]
        assert ext % step, rec          # the last sub-tile shifts inwards
        assert n >= 5
        plain = gk.run_plain(plan, inputs, rmins, params,
                             torch.device("cpu"))
        np.testing.assert_array_equal(plain.numpy(), gold)
        host = torch.zeros((a.shape[0], a.shape[1]), dtype=torch.int32)
        assert _host_build(plan, tmp_path)(*gk.launch_args(
            plan, inputs, rmins, host)) == 0
        np.testing.assert_array_equal(host.numpy(), gold,
                                      err_msg=str(rec))


# ---------------------------------------------------------------------------
# the apps: linear_blur (its store_root members, in full-width bands) and
# stencil_chain's slide branch (store_at the anchor's row loop)
# ---------------------------------------------------------------------------

def test_linear_blur_carry_matches_jax(monkeypatch):
    """linear_blur in 4 full-width bands: the JAX planner carries blur_x
    down its band split (simple_blur is read at y alone, no overlap); the
    port carries nothing. Values within the app's tolerance of the JAX
    package's (f32, another libm's pow)."""
    from halide_tpu.apps import get
    from halide_tpu_torch.apps import linear_blur
    app = linear_blur.build(64, 1024)
    data = app.make_inputs(3)
    app.bind(data, "cpu")
    gk.last_plan = None
    out = app.realize("cpu").to_numpy()
    rec = gk.last_plan
    japp = get("linear_blur")(width=64, height=1024)
    japp.bind(data)
    from halide_tpu.ops import pallas_group as pg
    pg._last_plan = None
    ref = np.asarray(japp.realize().to_numpy())
    assert pg._last_plan["sliding"] == ["blur_x"]
    assert "sliding" not in rec and rec["grid"] == rec["sub_tiles"], rec
    assert rec["band_walk"] and rec["members"] == ["blur_x", "simple_blur"]
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, app.reference(**data), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("w,h", [(256, 128), (256, 512)])
def test_stencil_chain_slide_carry_matches_jax(w, h, monkeypatch):
    """stencil_chain's slide=128 branch (12 stencils): the JAX planner
    carries every member of each group along x; the port carries none, and
    the outputs equal the JAX package's and numpy's bit for bit."""
    from halide_tpu.apps import get
    from halide_tpu.ops import pallas_group as pg
    from halide_tpu_torch.apps import stencil_chain
    recs = []
    orig = gk.run_plain

    def spy(plan, *a, **k):
        recs.append(plan.record())
        return orig(plan, *a, **k)
    monkeypatch.setattr(gk, "run_plain", spy)
    app = stencil_chain.build(w, h, 12, slide=128)
    data = app.make_inputs(0)
    app.bind(data, "cpu")
    before = sum(gk.rejects.values())
    out = app.realize("cpu").to_numpy()
    assert sum(gk.rejects.values()) == before, dict(gk.rejects)
    monkeypatch.setenv("HALIDE_TPU_SC_SLIDE", "128")
    pg._plans_by_name.clear()
    japp = get("stencil_chain")(width=w, height=h, stencils=12)
    japp.bind(data)
    ref = np.asarray(japp.realize().to_numpy())
    assert [r["func"] for r in recs] == ["stage_7", "stage_11"]
    for r in recs:
        assert pg._plans_by_name[r["func"]]["sliding"] == sorted(
            r["members"]), pg._plans_by_name[r["func"]]
        assert "sliding" not in r and r["grid"] == r["sub_tiles"], r
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, app.reference(**data))


def test_stencil_chain_slide_source_on_host(tmp_path):
    """stencil_chain's first slide group (8 stencils, 15 members stored at
    the row loop) at a 16x8 sub-tile, where the deep members' overlap (up
    to 32 columns) is twice the step: the g++ build equals the plain
    version bit for bit."""
    from halide_tpu_torch.apps import stencil_chain
    app = stencil_chain.build(256, 128, 12, slide=128)
    app.bind(app.make_inputs(0), "cpu")
    app.realize("cpu")
    (plan, inputs, rmins, params, _r), = [
        c for c in gk.group_calls(app.pipeline, "cpu", lambda p: [
            dict(sub_tile=(16, 8), threads=128)] if p.f.name == "stage_7"
            else [])]
    assert len(plan.members) == 15
    assert max(m.dims[0][3] for m in plan.members) - 16 > 16
    plain = gk.run_plain(plan, inputs, rmins, params, torch.device("cpu"))
    host = torch.zeros(tuple(reversed(plan.extents)), dtype=torch.uint16)
    assert _host_build(plan, tmp_path)(*gk.launch_args(
        plan, inputs, rmins, host)) == 0
    np.testing.assert_array_equal(host.numpy(), plain.numpy())


# ---------------------------------------------------------------------------
# the store level changes no plan
# ---------------------------------------------------------------------------

def _lesson_30(store):
    """Lesson 30's schedule (tutorials_torch/lesson_30_sliding_and_tails.py):
    a vertical blur computed at the x tiles of a horizontal one and stored
    at its row loop, on extents that are not tile multiples."""
    x, y = ht.Var("x"), ht.Var("y")
    xo, yo, xi, yi = (ht.Var(n) for n in "xo yo xi yi".split())
    img = np.random.default_rng(30).integers(0, 1 << 14, (256, 512),
                                             np.uint16)
    inp = ht.Buffer(img, name="l30_in")
    bv, bh = ht.Func("l30_bv"), ht.Func("l30_bh")
    bv[x, y] = (inp[x, y] + inp[x, y + 1] + inp[x, y + 2]) / 3
    bh[x, y] = (bv[x, y] + bv[x + 1, y] + bv[x + 2, y]) / 3
    bh.tile(x, y, xo, yo, xi, yi, 128, 64).vectorize(xi).parallel(yo)
    bv.compute_at(bh, xo)
    if store:
        bv.store_at(bh, yo)
    return lambda: ht.Pipeline(bh).realize([510, 254], device="cpu")


def _app_realize(name, **kw):
    from halide_tpu_torch.apps import get

    def make(store):
        app = get(name)(**kw)
        if not store:
            from halide_tpu_torch.pipeline import gather_graph
            from halide_tpu_torch.schedule import LoopLevel
            for fn in gather_graph(app.pipeline.outputs).funcs:
                if fn._fschedule.compute_level.kind == "at":
                    fn._fschedule.store_level = LoopLevel()
        app.bind(app.make_inputs(0), "cpu")
        return lambda: app.realize("cpu")
    return make


STORE_CASES = {
    "linear_blur": _app_realize("linear_blur", width=64, height=1024),
    "stencil_chain_slide128": _app_realize("stencil_chain", width=256,
                                           height=256, stencils=12,
                                           slide=128),
    "lesson_30": _lesson_30,
}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_store_levels_change_no_plan(case):
    """Each group's plan (its record, the rule's terms) and emitted source
    are the same with and without its members' store_at/store_root."""
    def plans(store):
        got = []
        with gk.planning(lambda plan, _m, _p: got.append(plan)):
            STORE_CASES[case](store)()
        return got
    with_store, without = plans(True), plans(False)
    assert with_store and len(with_store) == len(without)
    for p, q in zip(with_store, without):
        assert p.record() == q.record()
        assert p.source == q.source


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["x_carry", "y_carry"])
def test_carry_cases_kernel_on_the_card(case):
    _card()
    img = _box3_input(case)
    by, sizes = _box3(ht, img, case, "cuda")
    pipe = ht.Pipeline(by)
    launches = gk.launches
    out = pipe.realize(sizes)
    assert gk.launches == launches + 1
    plan, inputs, rmins, params, _r = gk.group_call(pipe)
    plain = gk.run_plain(plan, inputs, rmins, params, inputs[0].device)
    assert torch.equal(out.data, plain)
    assert torch.equal(gk.launch(plan, inputs, rmins), plain), plan.record()
    np.testing.assert_array_equal(out.to_numpy(), _box3_golden(img, case))


@pytest.mark.gpu
@pytest.mark.parametrize("axis", ["x", "y"])
def test_chain_carry_kernel_on_the_card(axis):
    _card()
    a = _chain_input(axis)
    pipe, sizes = _chain(ht, a, axis, "cuda")
    pipe.realize(sizes)
    gold = torch.from_numpy(_chain_golden(a)).cuda()
    for plan, inputs, rmins, params, _r in gk.group_calls(
            pipe, None, lambda p: [dict(sub_tile=s, threads=128)
                                   for s in CHAIN_SUBS[axis]]):
        assert torch.equal(gk.launch(plan, inputs, rmins), gold), \
            plan.record()


@pytest.mark.gpu
def test_stencil_chain_slide_kernel_on_the_card():
    _card()
    from halide_tpu_torch.apps import stencil_chain
    app = stencil_chain.build(1536, 512, 32, slide=512)
    data = app.make_inputs(0)
    app.bind(data)
    launches = gk.launches
    out = app.realize()
    assert gk.launches == launches + 4
    for plan, inputs, rmins, params, _r in gk.group_calls(app.pipeline):
        plain = gk.run_plain(plan, inputs, rmins, params, inputs[0].device,
                             {0, plan.ncy - 1})
        ys = torch.tensor(gk.plain_rows(plan, {0, plan.ncy - 1}),
                          device=plain.device)
        # (u16 has no CUDA indexing: compared as i32)
        assert torch.equal(gk.launch(plan, inputs, rmins).int()[ys],
                           plain.int()[ys])
    np.testing.assert_array_equal(out.to_numpy(), app.reference(**data))

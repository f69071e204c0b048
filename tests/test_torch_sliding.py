"""The sliding-window carry of the stencil-group kernel (K1): a member stored
at a loop that encloses its compute loop (`store_at(f, yo)` or
`store_root()`) keeps its buffer across the sub-tiles a block walks, computes
its whole footprint at the walk's first step and only the new band at each
later one. The JAX package's group kernel does the same across its
sequential grid steps (`pallas_group.py:1229-1307`, `:1476-1521`).

On the CPU: the port's `sliding` against the JAX planner's
(`pallas_group._last_plan["sliding"]`) on the carry cases of
tests/test_pallas.py, linear_blur and stencil_chain's slide branch, the
outputs against the JAX package's (Pallas in interpret mode) and numpy; and
the emitted source built with g++, walking 1, 2, 3 and 5 sub-tiles a block
along x and along y with one and two window buffers, against the plain
version and numpy, bit for bit (integer pipelines). The host build runs the
card's blocks one after another with one thread each, so the carry's
passes that move the overlap to the front of a buffer, its first-step and
band loops and the shifted-inwards last sub-tile are the card's; only the
card's own copies and barriers run on the card (the tests marked gpu)."""
import copy

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
    """The port carries exactly the members the JAX planner carries, along
    the same axis (x across the tiles of a row; y down the band walk, with
    the JAX package's double-buffered DMA forced as its test does), and the
    outputs are bit for bit the JAX package's and numpy's."""
    import halide_tpu as hl
    img = _box3_input(case)
    by, sizes = _box3(ht, img, case)
    out, rec = _realize_port(ht.Pipeline(by), sizes)
    if case == "y_carry":
        monkeypatch.setenv("HALIDE_TPU_FORCE_PIPELINE", "1")
    jby, _ = _box3(hl, img, case)
    ref, jrec = _realize_jax(jby, sizes)
    want = BOX3_CASES[case][3]
    assert rec["sliding"] == jrec["sliding"] == want, (rec, jrec)
    assert rec["band_walk"] == jrec["band_split"] == (case == "y_carry")
    if want:
        assert rec["axis"] == ("y" if case == "y_carry" else "x")
        assert rec["walk"] >= 2
    else:
        assert rec["walk"] == 1
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, _box3_golden(img, case))


@pytest.mark.parametrize("case", ["x_carry", "y_carry"])
def test_carry_cases_source_on_host(case, tmp_path):
    """The g++ build of the carried plan at walks of 1, 2, 3 and 5
    sub-tiles, with one window buffer and two, equals numpy bit for bit;
    so does the plan built with no carry."""
    img = _box3_input(case)
    by, sizes = _box3(ht, img, case)
    pipe = ht.Pipeline(by)
    out, _rec = _realize_port(pipe, sizes)
    gold = _box3_golden(img, case)
    np.testing.assert_array_equal(out, gold)
    plan, inputs, rmins, _p, _r = gk.group_call(pipe, "cpu")
    assert plan.sliding == BOX3_CASES[case][3]
    assert ("CARRY = true" in plan.source) == bool(plan.sliding)
    fn = _host_build(plan, tmp_path)
    for p in _walks_of(plan):
        host = torch.zeros(tuple(reversed(p.extents)), dtype=torch.uint16)
        assert fn(*gk.launch_args(p, inputs, rmins, host)) == 0
        np.testing.assert_array_equal(host.numpy(), gold,
                                      err_msg=str(p.record()))
    (q, *_x), = gk.group_calls(pipe, "cpu", lambda p: [dict(
        sub_tile=(plan.sx, plan.sy), threads=plan.threads, carry=False)])
    assert q.sliding == [] and q.walk == 1
    assert "CARRY = false" in q.source and "SHIFT_PASSES = 0" in q.source
    host = torch.zeros(tuple(reversed(q.extents)), dtype=torch.uint16)
    assert _host_build(q, tmp_path)(*gk.launch_args(q, inputs, rmins,
                                                    host)) == 0
    np.testing.assert_array_equal(host.numpy(), gold)


def _walks_of(plan):
    """The plan walking 1, 2, 3 and 5 sub-tiles a block along its axis,
    with one window buffer and, where a window moves along the axis, two
    (where they fit the shared memory)."""
    out = []
    for walk in (1, 2, 3, 5):
        for n_buf in (1, 2) if any(gk._walks(w, plan.axis)
                                   for w in plan.windows) else (1,):
            p = copy.copy(plan)
            p.walk, p.n_buf = walk, n_buf
            try:
                p.shape()
            except ValueError:
                continue
            out.append(p)
    return out


# ---------------------------------------------------------------------------
# a member chain carried along x or y at narrow sub-tiles: overlaps larger
# than the step, ragged extents (the last sub-tile shifted inwards), members
# carried beside one that is not
# ---------------------------------------------------------------------------

def _chain(m, a, axis, device="cpu"):
    """inp (edge-clamped, i32) -> c0 -> c1 -> c2, each reading its producer
    at (x - 1, y), (x + 2, y + 1) and (x, y - 1), -> out (tiled) reading c2
    at x and x + 1. Along x all three carry (overlaps 7, 4 and 1); along y
    c0 and c1 (4 and 2), c2 being read at y alone. -> (pipeline, sizes)."""
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
    """The planner's own plan of the chain: the port's `sliding` equals the
    JAX planner's, and the outputs equal the JAX package's and numpy's."""
    import halide_tpu as hl
    a = _chain_input(axis)
    pipe, sizes = _chain(ht, a, axis)
    out, rec = _realize_port(pipe, sizes)
    ref, jrec = _realize_jax(_chain(hl, a, axis)[0], sizes)
    assert rec["sliding"] == jrec["sliding"], (rec, jrec)
    assert rec["sliding"] == (["c0", "c1", "c2"] if axis == "x"
                              else ["c0", "c1"])
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, _chain_golden(a))


@pytest.mark.parametrize("axis", ["x", "y"])
def test_chain_carry_source_on_host(axis, tmp_path):
    """At sub-tiles whose step is below the members' overlap, on a ragged
    extent: the g++ build walking 1, 2, 3 and 5 sub-tiles a block, with one
    and two window buffers, and the plain version equal numpy bit for
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
        assert rec["axis"] == axis and rec["sliding"], rec
        step = plan.sx if axis == "x" else plan.sy
        over = [m.dims[m.carry][3] - step for m in plan.members
                if m.carry is not None]
        assert max(over) > step, rec
        n = plan.ncx if axis == "x" else plan.ncy
        ext = plan.extents[plan.xi if axis == "x" else plan.yi]
        assert ext % step, rec          # the last sub-tile shifts inwards
        assert n >= 5
        plain = gk.run_plain(plan, inputs, rmins, params,
                             torch.device("cpu"))
        np.testing.assert_array_equal(plain.numpy(), gold)
        fn = _host_build(plan, tmp_path)
        walks = _walks_of(plan)
        assert {p.n_buf for p in walks} == {1, 2}
        for p in walks:
            host = torch.zeros((a.shape[0], a.shape[1]), dtype=torch.int32)
            assert fn(*gk.launch_args(p, inputs, rmins, host)) == 0
            np.testing.assert_array_equal(host.numpy(), gold,
                                          err_msg=str(p.record()))


def test_carried_members_keep_their_shared_memory():
    """A carried member's buffer is live over every phase of a walk: no
    other member's bytes overlap it, where the same plan with no carry lets
    the chain's buffers share by liveness."""
    a = _chain_input("x")
    pipe, sizes = _chain(ht, a, "x")
    _realize_port(pipe, sizes)
    (p, *_a), (q, *_b) = gk.group_calls(pipe, "cpu", lambda p: [
        dict(sub_tile=(8, 4), threads=128),
        dict(sub_tile=(8, 4), threads=128, carry=False)])
    assert p.sliding == ["c0", "c1", "c2"] and q.sliding == []
    spans = [(m.smem_off, m.smem_off + gk._aligned(m.nbytes()))
             for m in p.members]
    for i, (lo1, hi1) in enumerate(spans):
        for lo2, hi2 in spans[i + 1:]:
            assert hi1 <= lo2 or hi2 <= lo1, spans
    assert p.member_bytes == sum(gk._aligned(m.nbytes()) for m in p.members)
    assert q.member_bytes < p.member_bytes


def test_carry_dropped_for_shared_memory_is_named():
    """A sub-tile at which the carried members would pass the shared memory
    a block can take drops carries, the largest first, until the group fits
    (here all three: every member of the chain is live at once while one
    is carried), and the record names each dropped member and the reason;
    the values do not change."""
    a = _chain_input("x")
    pipe, sizes = _chain(ht, a, "x")
    _realize_port(pipe, sizes)
    limit = gk._SMEM_LIMIT
    try:
        (p, inputs, rmins, params, _r), = gk.group_calls(
            pipe, "cpu", lambda p: [dict(sub_tile=(16, 8), threads=128)])
        full = p.fixed_bytes + p.walk_bytes + p.member_bytes
        gk._SMEM_LIMIT = full - 1
        (q, *_x), = gk.group_calls(
            pipe, "cpu", lambda p: [dict(sub_tile=(16, 8), threads=128)])
    finally:
        gk._SMEM_LIMIT = limit
    assert p.sliding == ["c0", "c1", "c2"] and not p.carry_dropped
    assert q.carry_dropped and len(q.sliding) < 3
    assert set(q.carry_dropped) == set(p.sliding) - set(q.sliding)
    assert all("shared memory" in r for r in q.carry_dropped.values())
    np.testing.assert_array_equal(
        gk.run_plain(q, inputs, rmins, params, torch.device("cpu")).numpy(),
        _chain_golden(a))


# ---------------------------------------------------------------------------
# the apps: linear_blur (its store_root members, down the band walk) and
# stencil_chain's slide branch (store_at the anchor's row loop, along x)
# ---------------------------------------------------------------------------

def test_linear_blur_carry_matches_jax(monkeypatch):
    """linear_blur in 4 full-width bands: the port carries blur_x down the
    band walk as the JAX planner does under its band split; simple_blur is
    read at y alone, no overlap, and is not carried. Values within the
    app's tolerance of the JAX package's (f32, another libm's pow)."""
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
    assert rec["sliding"] == pg._last_plan["sliding"] == ["blur_x"]
    assert rec["axis"] == "y" and rec["walk"] >= 2
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, app.reference(**data), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("w,h", [(256, 128), (256, 512)])
def test_stencil_chain_slide_carry_matches_jax(w, h, monkeypatch):
    """stencil_chain's slide=128 branch (12 stencils): each group's carried
    members equal the JAX planner's for the same group, every member of a
    group with an overlap along x carried."""
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
        assert r["sliding"] == pg._plans_by_name[r["func"]]["sliding"], (
            r, pg._plans_by_name[r["func"]])
        assert r["sliding"] == sorted(r["members"])
        assert r["axis"] == "x" and r["walk"] >= 2
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, app.reference(**data))


def test_stencil_chain_slide_source_on_host(tmp_path):
    """stencil_chain's first slide group (8 stencils, 15 carried members) at
    a 16x8 sub-tile, where the deep members' overlap (up to 32 columns) is
    twice the step: the g++ build walking 1, 3 and 5 sub-tiles equals the
    plain version bit for bit."""
    from halide_tpu_torch.apps import stencil_chain
    app = stencil_chain.build(256, 128, 12, slide=128)
    app.bind(app.make_inputs(0), "cpu")
    app.realize("cpu")
    (plan, inputs, rmins, params, _r), = [
        c for c in gk.group_calls(app.pipeline, "cpu", lambda p: [
            dict(sub_tile=(16, 8), threads=128)] if p.f.name == "stage_7"
            else [])]
    assert len(plan.sliding) == 15
    assert max(m.dims[m.carry][3] for m in plan.members) - 16 > 16
    plain = gk.run_plain(plan, inputs, rmins, params, torch.device("cpu"))
    fn = _host_build(plan, tmp_path)
    for walk in (1, 3, 5):
        p = copy.copy(plan)
        p.walk = walk
        host = torch.zeros(tuple(reversed(p.extents)), dtype=torch.uint16)
        assert fn(*gk.launch_args(p, inputs, rmins, host)) == 0
        np.testing.assert_array_equal(host.numpy(), plain.numpy())


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
    assert plan.sliding == BOX3_CASES[case][3]
    plain = gk.run_plain(plan, inputs, rmins, params, inputs[0].device)
    assert torch.equal(out.data, plain)
    for p in _walks_of(plan):
        assert torch.equal(gk.launch(p, inputs, rmins), plain), p.record()
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
        for p in _walks_of(plan):
            assert torch.equal(gk.launch(p, inputs, rmins), gold), \
                p.record()


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
        assert plan.sliding and plan.walk >= 2
        q = copy.copy(plan)
        q.walk, q.n_buf = 1, 1
        assert torch.equal(gk.launch(plan, inputs, rmins),
                           gk.launch(q, inputs, rmins))
    np.testing.assert_array_equal(out.to_numpy(), app.reference(**data))

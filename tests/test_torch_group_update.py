"""Update definitions and tuple-valued members inside the stencil-group
kernel K1 (the JAX kernel computes a member's updates in the kernel where
the write and every self-read are at the member's pure vars,
`pallas_group.py:721-736`, `:1531-1547`).

One tiled group: a stencil member `ug_g` with no update and a member `ug_f`
with the updates of each case, the output tiled 32x16 over 70x40 and both
members computed at its tiles:

- pure: f = f * 2 + g (f32 and i32);
- two: two updates in order, the second reading an input stencil;
- swap: a tuple-valued f whose pure update swaps its two values (each
  value of the step reads the state before it: tuple semantics);
- masked: compositing's pattern, a 3x3 RDom whose `where` reads an input
  table at r.y and whose values mux on r.x;
- narrow: an RDom update over a (u8, u16) tuple: wrapping sums, u16
  products and `~` on u16;
- the rejects: a write at a constant column (non-aligned) and a read of
  f[max(x - 1, 0), y] (a shifted self-read; f[x - 1, y] alone would
  grow f's required region without end, which both packages refuse).

On the CPU each case's plan is held against the JAX planner's (a spy on
`pallas_group.try_pallas_group`, its reject reason `_last_reject`), the
port's plain version against the JAX package (integers bit for bit,
floats within 1e-6) and numpy, and the emitted source, built with g++,
against the plain version bit for bit. A member with an update stored at
the row loop is computed whole in every sub-tile, as every member is; the
JAX planner does not slide one either. On the card (marked gpu) the kernel
equals its plain version bit for bit.
"""
import numpy as np
import pytest
import torch

import halide_tpu_torch as ht
from halide_tpu_torch.ops import group_kernel as gk
from test_torch_group_kernel import _host_build

H, W, TILE = 40, 70, (32, 16)
CASES = ["pure", "two", "swap", "masked", "narrow"]
REJECTS = {"nonaligned": "member ug_f: non-aligned update write",
           "shifted": "member ug_f: shifted self-read update"}


def _types(m, case, dtype):
    if case == "narrow":
        return m.UInt(8), m.UInt(16)
    t = m.Float(32) if dtype == "f32" else m.Int(32)
    return t, t


def update_group(m, case, a, tbl, dtype="i32", device="cpu", tile=TILE):
    """The group of `case` in package m over the input a (the port's on
    `device`) and the 3-entry table tbl; tile None: untiled. -> the
    pipeline."""
    x, y = m.Var("x"), m.Var("y")
    xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
    t0, t1 = _types(m, case, dtype)
    inp = m.ImageParam(t0, 2, "uin")
    ops = m.ImageParam(m.Int(32), 1, "uops")
    c = m.repeat_edge(inp)
    g, f = m.Func("ug_g"), m.Func("ug_f")
    g[x, y] = c[x + 1, y] - c[x, y - 1]
    if case == "pure":
        f[x, y] = c[x, y]
        f[x, y] = f[x, y] * 2 + g[x, y]
    elif case == "two":
        f[x, y] = c[x, y]
        f[x, y] = f[x, y] * 2 + g[x, y]
        f[x, y] = f[x, y] - c[x - 1, y + 1]
    elif case == "swap":
        f[x, y] = (c[x, y], g[x, y])
        f[x, y] = (f[x, y][1], f[x, y][0])
    elif case == "masked":
        r = m.RDom(0, 3, 0, 3, "ur")
        r.where(r.x == ops[r.y])
        f[x, y] = (c[x, y], g[x, y])
        a0, a1 = f[x, y][0], f[x, y][1]
        s = c[x + r.y, y]
        f[x, y] = (m.mux(r.x, [a0 + a1 * s, a0 * 3 - a1, a1 - s]),
                   m.mux(r.x, [a1 - a0, a1 + s, a0 * a1]))
    elif case == "narrow":
        r = m.RDom(0, 4, "un")
        f[x, y] = (c[x, y], m.cast(t1, g[x, y]))
        a0, a1 = f[x, y][0], f[x, y][1]
        f[x, y] = (a0 * 3 + c[x + r.x, y],
                   a1 * m.cast(t1, a0) + ~a1)
    elif case == "nonaligned":
        f[x, y] = c[x, y]
        f[0, y] = f[0, y] + g[0, y]
    elif case == "shifted":
        f[x, y] = c[x, y]
        f[x, y] = f[m.max(x - 1, 0), y] + g[x, y]
    out = m.Func("ug_out")
    if case in ("swap", "masked", "narrow"):
        out[x, y] = m.cast(t1, f[x, y][0]) * 2 + m.cast(t1, f[x, y][1]) \
            - m.cast(t1, g[x, y])
    else:
        out[x, y] = f[x, y] + g[x, y]
    if tile is not None:
        out.tile(x, y, xo, yo, xi, yi, tile[0], tile[1])
        for fn in (g, f):
            fn.compute_at(out, xo)
    if m is ht:
        inp.set(m.Buffer(torch.from_numpy(a).to(device)))
        ops.set(m.Buffer(torch.from_numpy(tbl).to(device)))
    else:
        inp.set(m.Buffer(a))
        ops.set(m.Buffer(tbl))
    return m.Pipeline(out)


def _data(case, dtype="i32", seed=0):
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 3, 3).astype(np.int32)
    if case == "narrow":
        return rng.integers(0, 256, (H, W)).astype(np.uint8), tbl
    if dtype == "f32":
        return rng.random((H, W), np.float32), tbl
    return rng.integers(-50, 50, (H, W)).astype(np.int32), tbl


def _golden(case, a, tbl):
    """numpy's values of the group (the input edge-replicated; integer
    arithmetic wrapping at each value's width)."""
    p = np.pad(a, 4, mode="edge")

    def at(dx, dy):
        return p[4 + dy:4 + dy + H, 4 + dx:4 + dx + W]
    g = at(1, 0) - at(0, -1)
    if case == "pure":
        return at(0, 0) * 2 + g + g
    if case == "two":
        return at(0, 0) * 2 + g - at(-1, 1) + g
    if case == "swap":
        return g * 2 + at(0, 0) - g
    if case == "masked":
        a0, a1 = at(0, 0).copy(), g.copy()
        for ry in range(3):
            rx = int(tbl[ry])
            s = at(ry, 0)
            a0, a1 = ([a0 + a1 * s, a0 * 3 - a1, a1 - s][rx],
                      [a1 - a0, a1 + s, a0 * a1][rx])
        return a0 * 2 + a1 - g
    assert case == "narrow"
    a0, a1 = at(0, 0).astype(np.uint8), g.astype(np.uint16)
    for rx in range(4):
        a0, a1 = (a0 * np.uint8(3) + at(rx, 0).astype(np.uint8),
                  a1 * a0.astype(np.uint16) + ~a1)
    return a0.astype(np.uint16) * np.uint16(2) + a1 - g.astype(np.uint16)


def _port(case, dtype="i32", seed=0):
    """The port's realize on the CPU, with no rejected plan. -> (pipeline,
    output, the group call made again)."""
    a, tbl = _data(case, dtype, seed)
    p = update_group(ht, case, a, tbl, dtype)
    before = sum(gk.rejects.values())
    gk.last_plan = None
    out = p.realize([W, H], device="cpu").to_numpy()
    assert sum(gk.rejects.values()) == before, dict(gk.rejects)
    assert gk.last_plan["members"] == ["ug_g", "ug_f"]
    return p, out, gk.group_call(p, "cpu")


def _jax(case, dtype="i32", seed=0):
    """The JAX package's realize (its group kernel in interpret mode),
    whether its group kernel engaged, and its planner's last reject."""
    import halide_tpu as hl
    from halide_tpu.ops import pallas_group as pg
    a, tbl = _data(case, dtype, seed)
    calls = []
    orig = pg.try_pallas_group

    def spy(*args, **kw):
        r = orig(*args, **kw)
        calls.append(r is not None)
        return r
    pg.try_pallas_group = spy
    pg._last_reject = None
    try:
        out = np.asarray(update_group(hl, case, a, tbl, dtype)
                         .realize([W, H]).to_numpy())
    finally:
        pg.try_pallas_group = orig
    return out, calls, pg._last_reject


@pytest.mark.parametrize("case,dtype", [(c, "i32") for c in CASES]
                         + [("pure", "f32"), ("swap", "f32")])
def test_update_group_engages_and_matches_jax(case, dtype):
    """Both planners take the group; the values equal the JAX package's
    (integers bit for bit, f32 within 1e-6) and numpy's, and the untiled
    pipeline's."""
    a, tbl = _data(case, dtype)
    _p, got, _call = _port(case, dtype)
    want, engaged, reject = _jax(case, dtype)
    assert engaged == [True], reject
    gold = _golden(case, a, tbl)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(got, gold, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, gold.astype(got.dtype))
    whole = update_group(ht, case, a, tbl, dtype, tile=None).realize(
        [W, H], device="cpu").to_numpy()
    np.testing.assert_array_equal(got, whole)


@pytest.mark.parametrize("case", sorted(REJECTS))
def test_update_group_rejects_as_jax(case):
    """A write at a constant column and a read of f[x - 1, y] make both
    planners reject the group with the reference's reason; both then
    compute it whole-array, to the same values."""
    a, tbl = _data(case)
    before = gk.rejects[REJECTS[case]]
    gk.last_plan = None
    got = update_group(ht, case, a, tbl).realize([W, H],
                                                 device="cpu").to_numpy()
    assert gk.rejects[REJECTS[case]] == before + 1
    assert gk.last_plan is None
    want, engaged, reject = _jax(case)
    assert engaged == [False] and reject == REJECTS[case]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_emitted_updates_on_host_match_plain_version(case, tmp_path):
    """The emitted update stages (the state in locals, an RDom update a
    loop with r.x innermost and its `where` skipping points, every value
    of a step computed before any is written), built with g++, equal the
    plain version bit for bit, which equals the realize's output."""
    _p, out, (plan, inputs, rmins, params, _r) = _port(case)
    fn = _host_build(plan, tmp_path)
    host = torch.empty(tuple(reversed(plan.extents)),
                       dtype=torch.from_numpy(out).dtype)
    assert fn(*gk.launch_args(plan, [t.contiguous() for t in inputs],
                              rmins, host)) == 0
    plain = gk.run_plain(plan, inputs, rmins, params, torch.device("cpu"))
    assert torch.equal(host, plain)
    assert torch.equal(plain, torch.from_numpy(out))
    f = next(s for s in plan.members if s.name == "ug_f")
    assert len(f.types) == (1 if case in ("pure", "two") else 2)
    assert len(f.updates) == (2 if case == "two" else 1)
    if case in ("masked", "narrow"):
        assert "for (int u" in plan.source


@pytest.mark.parametrize("case", ["masked", "pure"])
def test_plain_runs_equal_its_sub_tiles(case, monkeypatch):
    """The plain version evaluates runs of sub-tile rows as one box
    (`_plain_runs`): the same values as each sub-tile alone."""
    _p, out, (plan, inputs, rmins, params, _r) = _port(case)
    dev = torch.device("cpu")
    runs = gk._plain_runs(plan)
    assert len(runs) == 1 and runs[0][0] != runs[0][1]
    monkeypatch.setattr(gk, "_tracks_by_data", lambda plan: True)
    assert len(gk._plain_runs(plan)) == plan.ncx * plan.ncy
    assert torch.equal(gk.run_plain(plan, inputs, rmins, params, dev),
                       torch.from_numpy(out))


def test_member_with_an_update_is_not_carried():
    """The schedule of tests/test_pallas.py:361 (the member stored at the
    row loop, which the JAX planner carries along x) with an update on the
    member: neither planner carries it, the port's plan is one sub-tile a
    block, and the values equal the JAX package's and numpy's."""
    import halide_tpu as hl
    from halide_tpu.ops import pallas_group as pg
    img = np.random.default_rng(11).integers(0, 1 << 14, (64, 256),
                                             np.uint16)

    def build(m):
        x, y = m.Var("x"), m.Var("y")
        xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
        inp = m.Buffer(torch.from_numpy(img) if m is ht else img)
        bx, by = m.Func("swu_bx"), m.Func("swu_by")
        bx[x, y] = (inp[x, y] + inp[x, y + 1] + inp[x, y + 2]) / 3
        bx[x, y] = bx[x, y] + 1
        by[x, y] = (bx[x, y] + bx[x + 1, y] + bx[x + 2, y]) / 3
        by.tile(x, y, xo, yo, xi, yi, 64, 16).vectorize(xi).parallel(yo)
        bx.compute_at(by, xo).store_at(by, yo)
        return m.Pipeline(by)
    before = sum(gk.rejects.values())
    got = build(ht).realize([254, 62], device="cpu").to_numpy()
    assert sum(gk.rejects.values()) == before
    rec = gk.last_plan
    assert rec["members"] == ["swu_bx"] and rec["grid"] == rec["sub_tiles"]
    pg._last_plan = None
    want = np.asarray(build(hl).realize([254, 62], jit=False).to_numpy())
    assert pg._last_plan is not None and pg._last_plan["sliding"] == []
    np.testing.assert_array_equal(got, want)
    a = img.astype(np.uint16)
    r = (a[:-2] + a[1:-1] + a[2:]) // 3 + 1
    np.testing.assert_array_equal(got, (r[:, :-2] + r[:, 1:-1]
                                        + r[:, 2:]) // 3)


def test_member_ops_count_updates_by_their_points():
    """An update counts its predicates at every point of its RDom and its
    values at each point (or at the points that pass on a run's data,
    `update_passing`, where a mux at an RVar counts the branch it takes):
    the masked case's `r.x == ops[r.y]` passes at one r.x for each r.y."""
    _p, _out, (plan, _in, _rm, params, realz) = _port("masked")
    f = next(s for s in plan.members if s.name == "ug_f")
    _d, vals, preds = f.updates[0]
    passing = gk.update_passing(f, realz, params, "cpu")
    tbl = _data("masked")[1]
    assert passing == [[(int(tbl[ry]), ry) for ry in range(3)]]
    assert gk.point_ops(preds) == (0, 1)
    pure = gk.point_ops(f.values)
    every = gk.member_ops(f)
    assert every == (0, pure[1] + 9 * (1 + gk.point_ops(vals)[1]))
    seen = gk.member_ops(f, passing)
    # each passing point computes one mode of each value: (a0 + a1 * s,
    # a1 - a0), (a0 * 3 - a1, a1 + s) or (a1 - s, a0 * a1)
    per_mode = {0: 3, 1: 3, 2: 2}
    assert seen == (0, pure[1] + 9 + sum(per_mode[rx] for rx, _ry in
                                         passing[0]))


def test_data_dependent_index_stays_in_its_window(tmp_path):
    """A table Func (computed at root, over the range its reads need) read
    at a data-dependent index. Where the bounds engine cannot bound the
    index (an f32 input cast to i32), the pipeline refuses it, asking for a
    clamp. Where the index is a clamp to the table's realized range, the
    plan strips it (the window replicates the edge) and what is left has
    no bound a window can hold: the plan rejects, and the group runs
    whole-array. Where the engine bounds it (a u8 input: [0, 255]; the f32
    value clamped to [0, 11] before the cast, as bilateral_grid's z), the
    window's dim holds the table's whole realized extent, and the kernel
    also clamps the index into the window, as the plain version's gather
    clips it, so that no read leaves it: the g++ build equals the plain
    version, the untiled pipeline and numpy."""
    rng = np.random.default_rng(5)

    def build(a, how, tile=TILE):
        x, y, z = ht.Var("x"), ht.Var("y"), ht.Var("z")
        xo, yo, xi, yi = ht.Var("xo"), ht.Var("yo"), ht.Var("xi"), \
            ht.Var("yi")
        inp = ht.Buffer(torch.from_numpy(a))
        tbl = ht.Func("dd_tbl")
        tbl[z] = ht.f32(z) * 10.0
        tbl.compute_root()
        v = inp[x, y]
        i = {"raw": ht.i32(v), "index": ht.clamp(ht.i32(v), 0, 11),
             "value": ht.i32(ht.clamp(v, 0.0, 11.0))}[how]
        p, o = ht.Func("dd_p"), ht.Func("dd_o")
        p[x, y] = tbl[i] + ht.f32(v)
        o[x, y] = p[x, y] * 2
        if tile is not None:
            o.tile(x, y, xo, yo, xi, yi, tile[0], tile[1])
            p.compute_at(o, xo)
        return ht.Pipeline(o)

    def golden(a, hi):
        idx = np.clip(a.astype(np.int32), 0, hi).astype(np.float32)
        return (idx * np.float32(10) + a.astype(np.float32)) * 2
    af = (rng.random((H, W), np.float32) * 12).astype(np.float32)
    with pytest.raises(ht.CompileError, match="cannot bound"):
        build(af, "raw").realize([W, H], device="cpu")
    before = sum(gk.rejects.values())
    gk.last_plan = None
    got = build(af, "index").realize([W, H], device="cpu").to_numpy()
    assert sum(gk.rejects.values()) == before + 1 and gk.last_plan is None
    np.testing.assert_array_equal(got, golden(af, 11))
    a8 = rng.integers(0, 256, (H, W)).astype(np.uint8)
    for a, how, hi in ((a8, "raw", 255), (af, "value", 11)):
        pipe = build(a, how)
        before = sum(gk.rejects.values())
        got = pipe.realize([W, H], device="cpu").to_numpy()
        assert sum(gk.rejects.values()) == before, dict(gk.rejects)
        plan, inputs, rmins, params, _r = gk.group_call(pipe, "cpu")
        win = next(w for w in plan.windows if w.name == "dd_tbl")
        assert win.dims == [("s", 1, 0, hi + 1)]
        assert "hl_min<int>(hl_max<int>(" in plan.source
        fn = _host_build(plan, tmp_path)
        host = torch.empty((H, W), dtype=torch.float32)
        assert fn(*gk.launch_args(plan, [t.contiguous() for t in inputs],
                                  rmins, host)) == 0
        plain = gk.run_plain(plan, inputs, rmins, params,
                             torch.device("cpu"))
        assert torch.equal(host, plain)
        assert torch.equal(plain, torch.from_numpy(got))
        whole = build(a, how, tile=None).realize(
            [W, H], device="cpu").to_numpy()
        np.testing.assert_array_equal(got, whole)
        np.testing.assert_array_equal(got, golden(a, hi))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_update_group_kernel_matches_plain_version_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, tbl = _data(case)
    p = update_group(ht, case, a, tbl, device="cuda")
    launches = gk.launches
    out = p.realize([W, H])
    assert gk.launches == launches + 1
    plan, inputs, rmins, params, _realz = gk.group_call(p)
    plain = gk.run_plain(plan, inputs, rmins, params, inputs[0].device)
    torch.cuda.synchronize()
    assert torch.equal(out.data, plain)
    np.testing.assert_array_equal(out.to_numpy(), _golden(case, a, tbl)
                                  .astype(out.to_numpy().dtype))

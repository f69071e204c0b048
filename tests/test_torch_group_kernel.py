"""The stencil-group kernel (halide_tpu_torch/ops/group_kernel.py) on the
CPU: its plain version against the JAX package's group kernel (Pallas in
interpret mode) and against whole-array eval_torch, and the emitted CUDA
source compiled with the host C++ compiler against the plain version. The
kernel itself runs only on the card (the test marked gpu).

The band walk (full-width row bands) is recorded as the JAX planner
decides its band split; its plan, as every plan, computes one sub-tile a
block with one window buffer, and the host build runs the same blocks, so
their index arithmetic is compared here; the kernel's own cp.async copies
only on the card.

blur is u16 and compares bit for bit. linear_blur is f32: the plain version
and whole-array eval_torch do the same f32 operations in the same order and
compare bit for bit; against the JAX package and against the host-compiled
source (another libm's powf) it allows the app's tolerance, 1e-4."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import halide_tpu_torch as ht
from halide_tpu_torch.apps import blur as tblur
from halide_tpu_torch.apps import linear_blur as tlinear_blur
from halide_tpu_torch.ops import group_kernel as gk

# (width, height, tile): output extents (w-2, h-2) are not tile multiples,
# so the shifted-inwards last tile is reached; the last case's tile is
# larger than the output and shrinks to it
BLUR_TILES = [(96, 64, (40, 24)), (96, 64, (32, 16)), (70, 50, (128, 96))]


def _torch_app(name, device="cpu", **kw):
    build = {"blur": tblur.build, "linear_blur": tlinear_blur.build}[name]
    app = build(**kw)
    data = app.make_inputs(3)
    app.bind(data, device)
    return app, data


def _group_call(name, **kw):
    """Realize through the group path; -> (output, the group call made
    again: plan, inputs, realized mins, params, whole-array stages)."""
    app, data = _torch_app(name, **kw)
    before = sum(gk.rejects.values())
    gk.last_plan = None
    out = app.realize("cpu").to_numpy()
    assert sum(gk.rejects.values()) == before, dict(gk.rejects)
    assert gk.last_plan is not None
    call = gk.group_call(app.pipeline, "cpu")
    assert call[0].f.name == app.pipeline.outputs[0].name
    return app, data, out, call


def _jax_realize(name, data, monkeypatch, tile=None, **kw):
    from halide_tpu.apps import get
    if tile is not None:
        monkeypatch.setenv("HALIDE_TPU_BLUR_TILE", f"{tile[0]}x{tile[1]}")
    app = get(name)(**kw)
    app.bind(data)
    return np.asarray(app.realize().to_numpy())


def _host_build(plan, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the emitted source")
    cu = tmp_path / f"{plan.symbol}.cu"
    so = tmp_path / f"{plan.symbol}.so"
    cu.write_text(plan.source)
    r = subprocess.run(
        [gxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
         "-ffp-contract=off", "-I", str(gk._CSRC), "-o", str(so), str(cu)],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    fn = getattr(ctypes.CDLL(str(so)), f"host_run_{plan.symbol}")
    fn.argtypes = plan.arg_types
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("w,h,tile", BLUR_TILES)
def test_blur_plain_version_matches_jax_group_kernel(w, h, tile,
                                                     monkeypatch):
    app, data, out, call = _group_call("blur", width=w, height=h, tile=tile)
    plan = call[0]
    assert (plan.tx, plan.ty) == (min(tile[0], w - 2), min(tile[1], h - 2))
    ref = _jax_realize("blur", data, monkeypatch, tile, width=w, height=h)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, app.reference(**data))


def test_linear_blur_plain_version_matches_jax_group_kernel(monkeypatch):
    app, data, out, call = _group_call("linear_blur", width=64, height=48)
    ref = _jax_realize("linear_blur", data, monkeypatch, width=64,
                       height=48)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, app.reference(**data), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name,kw", [
    ("blur", dict(width=96, height=64, tile=(40, 24))),
    ("blur", dict(width=70, height=50, tile=(128, 96))),
    ("linear_blur", dict(width=64, height=48)),
])
def test_plain_version_matches_whole_array(name, kw):
    app, _data, out, call = _group_call(name, **kw)
    realz = call[4]
    whole = realz[id(app.pipeline.outputs[0])].arrays[0].numpy()
    np.testing.assert_array_equal(out, whole)


def test_plan_record_and_sub_tiles():
    """linear_blur's tile is a full-width row band; the plan sub-tiles it
    by the rule: of every sub-tile within the 227 KB a block can take, at
    every thread count, the one with the least `_plan_score`; the grid
    covers the output extent once."""
    _app, _data, _out, call = _group_call("linear_blur", width=640,
                                          height=96)
    plan = call[0]
    rec = plan.record()
    assert rec["tile"] == (640, 96)
    sx, sy = rec["sub_tile"]
    assert sx <= 256 and sy <= 128 and rec["smem_bytes"] <= gk._SMEM_LIMIT
    assert rec["threads"] in gk._THREADS
    best = min(plan.candidates, key=lambda c: c["score"])
    assert rec["model"]["score"] == best["score"]
    assert len({c["sub_tile"] for c in plan.candidates}) > 1
    ext_x, ext_y = plan.extents[plan.xi], plan.extents[plan.yi]
    assert rec["grid"] == (-(-ext_x // sx), -(-ext_y // sy))
    assert rec["members"] == ["blur_x", "simple_blur"]
    assert rec["windows"] == ["srgb_to_linear"]


def test_plan_record_is_made_once_with_the_plan(monkeypatch):
    """A realize that hits the plan cache shows the record its first
    realize made, and makes none: nothing the record reads changes once
    the plan is made."""
    app, _data = _torch_app("blur", width=96, height=64, tile=(40, 24))
    app.realize("cpu")
    first = gk.last_plan
    plan = gk.group_call(app.pipeline, "cpu")[0]
    assert first == plan.record()
    made = []
    record = gk.GroupPlan.record
    monkeypatch.setattr(gk.GroupPlan, "record",
                        lambda self: made.append(1) or record(self))
    gk.last_plan = None
    app.realize("cpu")
    assert made == []
    assert gk.last_plan == first
    assert gk.plans_by_name[plan.f.name] == first


@pytest.mark.parametrize("name,kw", [
    ("blur", dict(width=96, height=64, tile=(40, 24))),
    ("linear_blur", dict(width=64, height=48)),
])
def test_emitted_source_on_host_matches_plain_version(name, kw, tmp_path):
    _app, _data, out, (plan, inputs, rmins, _p, _r) = _group_call(name,
                                                                   **kw)
    fn = _host_build(plan, tmp_path)
    host = torch.empty(tuple(reversed(plan.extents)),
                       dtype=torch.from_numpy(out).dtype)
    assert fn(*gk.launch_args(plan, [a.contiguous() for a in inputs],
                              rmins, host)) == 0
    if out.dtype.kind == "f":
        np.testing.assert_allclose(host.numpy(), out, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(host.numpy(), out)


def test_cpu_tensors_take_the_plain_version_and_launch_refuses_them():
    launches = gk.launches
    _app, _data, _out, (plan, inputs, rmins, _p, _r) = _group_call(
        "blur", width=96, height=64, tile=(40, 24))
    assert gk.launches == launches
    with pytest.raises(ValueError, match="not on the card"):
        gk.launch(plan, inputs, rmins)


def test_rejected_plan_counts_its_reason_and_evaluates_whole_array():
    """A producer read transposed does not track the tile: the plan
    rejects it, the reason is counted, and the group is evaluated
    whole-array with the same values."""
    x, y = ht.Var("x"), ht.Var("y")
    xo, yo, xi, yi = ht.Var("xo"), ht.Var("yo"), ht.Var("xi"), ht.Var("yi")
    inp = ht.ImageParam(ht.Int(32), 2, "inp")
    p, c = ht.Func("p"), ht.Func("c")
    p[x, y] = inp[x, y] * 3
    c[x, y] = p[y, x] + p[x, y]
    c.tile(x, y, xo, yo, xi, yi, 8, 8)
    p.compute_at(c, xo)
    a = np.arange(24 * 24, dtype=np.int32).reshape(24, 24)
    inp.set(torch.from_numpy(a))
    before = sum(gk.rejects.values())
    out = ht.Pipeline(c).realize([24, 24], device="cpu").to_numpy()
    assert sum(gk.rejects.values()) == before + 1
    assert any("tile dependence" in r for r in gk.rejects)
    np.testing.assert_array_equal(out, 3 * a.T + 3 * a)


@pytest.mark.gpu
@pytest.mark.parametrize("name,kw,tol", [
    ("blur", dict(width=2560, height=1536, tile=(256, 128)), 0),
    ("blur", dict(width=96, height=64, tile=(40, 24)), 0),
    ("linear_blur", dict(width=1536, height=2560), 1e-4),
])
def test_kernel_matches_plain_version_on_the_card(name, kw, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    app, data = _torch_app(name, device="cuda", **kw)
    launches = gk.launches
    out = app.realize()
    assert gk.launches == launches + 1
    plan, inputs, rmins, params, _realz = gk.group_call(app.pipeline)
    plain = gk.run_plain(plan, inputs, rmins, params, inputs[0].device)
    torch.cuda.synchronize()
    err = (out.data.double() - plain.double()).abs().max().item()
    assert err <= tol
    np.testing.assert_allclose(out.to_numpy().astype(np.float64),
                               app.reference(**data), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# div-indexed input windows (the counterpart of the JAX package's in-kernel
# repeat): a tiled consumer whose compute_at member reads a root Func at
# (x + c) / d on x, on y or on both. Output sizes are ragged (not tile
# multiples), and some tiles put a sub-tile origin off the multiples of d.
# ---------------------------------------------------------------------------

def _div_reads(m, src, x, y, form):
    """The member's value: reads of `src` in one of the div forms."""
    if form == "x2":
        return src[x / 2, y] + src[(x + 1) / 2, y] * 2 - src[(x - 1) / 2, y]
    if form == "y2":
        return src[x, y / 2] - src[x, (y + 1) / 2] + src[x, (y - 1) / 2] * 3
    if form == "xy2":       # interpolate's upsample: d = 2 on both axes
        return (src[x / 2, y / 2] + src[(x + 1) / 2, y / 2]
                + src[x / 2, (y + 1) / 2] + src[(x + 1) / 2, (y + 1) / 2])
    if form == "x8":
        return src[x / 8, y] * 5 + src[(x + 7) / 8, y]
    if form == "y8":
        return src[x, y / 8] - src[x, (y + 7) / 8]
    if form == "xy8":       # bilateral_grid's slice: d = 8 on both axes
        return src[x / 8, y / 8] + src[(x + 7) / 8, (y - 1) / 8] * 2
    if form == "x2y8":
        return src[(x - 1) / 2, y / 8] + src[x / 2, (y + 7) / 8]
    if form == "x2lerp":    # the pyramid upsample, its lerp of src's type
        return m.lerp(src[(x + 1) / 2, y], src[(x - 1) / 2, y],
                      ((x % 2) * 2 + 1) / 4.0)
    raise ValueError(form)


def _div_pipeline(m, form, dtype, tile, a_np, device="cpu"):
    """src (root, edge-clamped input * 3 + 1) -> p (compute_at, the div
    reads) -> c (tiled: p and its right neighbour). -> the Pipeline."""
    t = {"int32": m.Int(32), "uint16": m.UInt(16),
         "float32": m.Float(32)}[dtype]
    inp = m.ImageParam(t, 2, "inp")
    x, y = m.Var("x"), m.Var("y")
    xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
    src, p, c = m.Func("src"), m.Func("p"), m.Func("c")
    src[x, y] = m.repeat_edge(inp)[x, y] * 3 + 1
    p[x, y] = _div_reads(m, src, x, y, form)
    c[x, y] = p[x, y] + p[x + 1, y]
    src.compute_root()
    c.tile(x, y, xo, yo, xi, yi, tile[0], tile[1])
    p.compute_at(c, xo)
    inp.set(torch.from_numpy(a_np).to(device) if m is ht else a_np)
    return m.Pipeline(c)


def _div_input(dtype, seed=11):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        return rng.uniform(-2, 2, (40, 48)).astype(np.float32)
    hi = 1000 if dtype == "int32" else 1 << 14
    return rng.integers(-hi if dtype == "int32" else 0, hi,
                        (40, 48)).astype(dtype)


# (form, dtype, output w, h, tile): ragged extents, and tiles whose last
# sub-tile origin (tile - sub-tile) is not a multiple of d
DIV_CASES = [
    ("x2", "int32", 70, 50, (32, 16)),
    ("y2", "uint16", 70, 50, (32, 16)),
    ("xy2", "float32", 70, 50, (40, 24)),
    ("xy2", "int32", 61, 37, (36, 20)),
    ("x8", "int32", 70, 50, (36, 16)),
    ("y8", "uint16", 45, 61, (32, 20)),
    ("xy8", "float32", 70, 50, (32, 16)),
    ("xy8", "int32", 45, 61, (36, 20)),
    ("x2y8", "uint16", 70, 50, (40, 24)),
    ("x2lerp", "uint16", 61, 37, (36, 20)),
]


def _div_realize(form, dtype, w, h, tile):
    a = _div_input(dtype)
    pipe = _div_pipeline(ht, form, dtype, tile, a)
    before = sum(gk.rejects.values())
    gk.last_plan = None
    out = pipe.realize([w, h], device="cpu").to_numpy()
    assert sum(gk.rejects.values()) == before, dict(gk.rejects)
    return a, pipe, out


@pytest.mark.parametrize("form,dtype,w,h,tile", DIV_CASES)
def test_div_window_plan_matches_jax(form, dtype, w, h, tile):
    """The plan takes the div-indexed window (no reject); its plain
    version equals the JAX package bit for bit (int) or within 1e-6 (f32);
    the emitted source sets the window's origin with floor division."""
    a, pipe, out = _div_realize(form, dtype, w, h, tile)
    rec = gk.last_plan
    assert rec is not None and rec["func"] == "c" and rec["members"] == ["p"]
    ds = dict(rec["div_windows"]["src"])
    want = {"x2": {"x": 2}, "y2": {"y": 2}, "xy2": {"x": 2, "y": 2},
            "x8": {"x": 8}, "y8": {"y": 8}, "xy8": {"x": 8, "y": 8},
            "x2y8": {"x": 2, "y": 8}, "x2lerp": {"x": 2}}[form]
    assert ds == want
    plan = gk.group_call(pipe, "cpu")[0]
    for k, d in want.items():
        assert f"hl_div<int>({k}0, {d})" in plan.source
    import halide_tpu as hl
    ref = np.asarray(_div_pipeline(hl, form, dtype, tile, a)
                     .realize([w, h]).to_numpy())
    assert out.dtype == ref.dtype
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(out, ref)


def test_div_window_origins_are_floor_divided_with_slack():
    """At every sub-tile origin of a ragged plan, including the ones off
    the multiples of d, the staged window starts at floor(origin / d) +
    off and holds the footprint: one element of slack per div dim."""
    _a, pipe, _out = _div_realize("xy8", "int32", 45, 61, (36, 20))
    plan = gk.group_call(pipe, "cpu")[0]
    (win,) = plan.windows
    kinds = [(k, d) for k, d, _o, _e in win.dims]
    assert kinds == [("x", 8), ("y", 8)]
    origins = set(gk._origins(plan))
    assert any(x0 % 8 for x0, _ in origins) and any(y0 % 8 for _, y0 in origins)
    for x0, y0 in origins:
        (lx, ex), (ly, ey) = gk._stage_box(win, x0, y0)
        assert lx == x0 // 8 + win.dims[0][2] and ly == y0 // 8 + win.dims[1][2]
        # reads: x/8, (x+7)/8 over [x0, x0+sx+1) (p is read at x and x+1)
        assert lx <= x0 // 8 and (x0 + plan.sx + 7) // 8 <= lx + ex - 1
        assert ly <= (y0 - 1) // 8 and (y0 + plan.sy - 1) // 8 <= ly + ey - 1


@pytest.mark.parametrize("form,dtype,w,h,tile", [
    DIV_CASES[3], DIV_CASES[6], DIV_CASES[7], DIV_CASES[8], DIV_CASES[9]])
def test_div_window_source_on_host_matches_plain_version(form, dtype, w, h,
                                                         tile, tmp_path):
    _a, pipe, out = _div_realize(form, dtype, w, h, tile)
    plan, inputs, rmins, _p, _r = gk.group_call(pipe, "cpu")
    fn = _host_build(plan, tmp_path)
    host = torch.empty(tuple(reversed(plan.extents)),
                       dtype=torch.from_numpy(out).dtype)
    assert fn(*gk.launch_args(plan, [t.contiguous() for t in inputs],
                              rmins, host)) == 0
    np.testing.assert_array_equal(host.numpy(), out)


def test_member_with_div_indexed_footprint_is_rejected():
    """Only input windows take div-indexed dims (as in the JAX planner): a
    compute_at member read at x / 2 is rejected with its reason counted,
    and the group is evaluated whole-array with the same values."""
    x, y = ht.Var("x"), ht.Var("y")
    xo, yo, xi, yi = ht.Var("xo"), ht.Var("yo"), ht.Var("xi"), ht.Var("yi")
    inp = ht.ImageParam(ht.Int(32), 2, "inp")
    p, c = ht.Func("p"), ht.Func("c")
    p[x, y] = inp[x, y] * 3
    c[x, y] = p[x / 2, y] + p[(x + 1) / 2, y]
    c.tile(x, y, xo, yo, xi, yi, 16, 8)
    p.compute_at(c, xo)
    a = np.arange(24 * 24, dtype=np.int32).reshape(24, 24)
    inp.set(torch.from_numpy(a))
    before = gk.rejects["member p: div-indexed footprint"]
    out = ht.Pipeline(c).realize([32, 24], device="cpu").to_numpy()
    assert gk.rejects["member p: div-indexed footprint"] == before + 1
    xs = np.arange(32)
    np.testing.assert_array_equal(out, 3 * a[:, xs // 2] + 3 * a[:, (xs + 1) // 2])


@pytest.mark.gpu
@pytest.mark.parametrize("form,dtype,w,h,tile", [
    ("xy2", "float32", 1000, 700, (256, 64)),
    ("x2", "int32", 70, 50, (32, 16)),
    ("xy8", "int32", 45, 61, (36, 20)),
    ("xy8", "float32", 1000, 700, (256, 64)),
    ("x2y8", "uint16", 70, 50, (40, 24)),
    ("x2lerp", "uint16", 61, 37, (36, 20)),
])
def test_div_window_kernel_matches_plain_version_on_the_card(form, dtype, w,
                                                             h, tile):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    shape = (h // 2 + 8, w // 2 + 8)
    a = (rng.uniform(-2, 2, shape).astype(np.float32)
         if dtype == "float32" else
         rng.integers(0, 1000, shape).astype(dtype))
    pipe = _div_pipeline(ht, form, dtype, tile, a, "cuda")
    launches = gk.launches
    out = pipe.realize([w, h])
    assert gk.launches == launches + 1
    assert gk.last_plan["div_windows"]
    plan, inputs, rmins, params, _realz = gk.group_call(pipe)
    plain = gk.run_plain(plan, inputs, rmins, params, inputs[0].device)
    torch.cuda.synchronize()
    tol = 1e-6 if dtype == "float32" else 0
    err = (out.data.double() - plain.double()).abs().max().item()
    assert err <= tol


# ---------------------------------------------------------------------------
# the band walk (the counterpart of the JAX planner's band split, gated there
# by the probe `_bandsplit_ok`): the shapes of tests/test_pallas.py's band-
# split tests, and negative cases. A 3-tap box blur in u16, the output tiled
# in row bands of 128 and the x pass computed at the tiles.
# ---------------------------------------------------------------------------

# name -> (W, H, tile, parallel var, store_root, the JAX decision)
BAND_CASES = {
    "bands8": (256, 1026, (254, 128), "yo", False, True),
    "ragged_tail": (256, 1536, (254, 128), "yo", False, True),
    "store_root": (256, 1026, (254, 128), "yo", True, True),
    "parallel_xo": (256, 1026, (254, 128), "xo", False, False),
    "bands3": (256, 386, (254, 128), "yo", False, False),
    # two tiles across: neither walks. (At a ragged width the JAX package
    # partitions the output and band-splits its one-tile-wide interior,
    # where the port shifts the last tile inwards and has two tiles.)
    "narrow_tile": (258, 1026, (128, 128), "yo", False, False),
}


def _band_input(case, dtype="uint16"):
    """The window in u16 or i32: two element sizes for the staging's
    copies."""
    W, H = BAND_CASES[case][:2]
    return np.random.default_rng(21).integers(0, 1 << 14, (H, W)) \
        .astype(dtype)


def _band_pipeline(m, case, img, device="cpu"):
    W, H, (tx, ty), par, store_root, _ = BAND_CASES[case]
    x, y = m.Var("x"), m.Var("y")
    xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
    inp = m.Buffer(torch.from_numpy(img).to(device) if m is ht else img)
    bx, by = m.Func("band_bx"), m.Func("band_by")
    bx[x, y] = (inp[x, y] + inp[x + 1, y] + inp[x + 2, y]) / 3
    by[x, y] = (bx[x, y] + bx[x, y + 1] + bx[x, y + 2]) / 3
    by.tile(x, y, xo, yo, xi, yi, tx, ty).vectorize(xi).parallel(
        {"xo": xo, "yo": yo}[par])
    bx.compute_at(by, xo)
    if store_root:
        bx.store_root()
    return by, [W - 2, H - 2]


def _band_golden(img):
    ref = (img[:, :-2] + img[:, 1:-1] + img[:, 2:]) // 3
    return (ref[:-2] + ref[1:-1] + ref[2:]) // 3


def _band_realize(case, dtype="uint16"):
    img = _band_input(case, dtype)
    by, sizes = _band_pipeline(ht, case, img)
    pipe = ht.Pipeline(by)
    before = sum(gk.rejects.values())
    gk.last_plan = None
    out = pipe.realize(sizes, device="cpu").to_numpy()
    assert sum(gk.rejects.values()) == before, dict(gk.rejects)
    return img, pipe, out


@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_band_walk_decision_matches_jax_band_split(case):
    """The port walks bands exactly where the JAX planner band-splits; the
    record names the walk, and the values equal the JAX package's and the
    golden."""
    from halide_tpu.ops import pallas_group as pg
    import halide_tpu as hl
    img, _pipe, out = _band_realize(case)
    rec = gk.last_plan
    jby, sizes = _band_pipeline(hl, case, img)
    pg._last_plan = None
    ref = np.asarray(jby.realize(sizes, jit=False).to_numpy())
    assert pg._last_plan is not None
    assert rec["band_walk"] == pg._last_plan["band_split"] \
        == BAND_CASES[case][5], (rec, pg._last_plan)
    assert rec["grid"] == rec["sub_tiles"]
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, _band_golden(img))


def test_band_walk_plan_fields():
    """A band-walk plan computes one sub-tile a block: its grid is the
    sub-tiles of the output extent, and its shared memory its window's
    bytes then its members', the same fields as any other plan's."""
    for dtype in ("uint16", "int32"):
        _img, pipe, _out = _band_realize("bands8", dtype)
        plan = gk.group_call(pipe, "cpu")[0]
        rec = plan.record()
        assert plan.band_walk and rec["band_walk"]
        (win,) = plan.windows
        assert [k for k, _d, _o, _e in win.dims] == ["x", "y"]
        ext_x, ext_y = plan.extents[plan.xi], plan.extents[plan.yi]
        assert rec["grid"] == rec["sub_tiles"] == (plan.ncx, plan.ncy) == (
            -(-ext_x // plan.sx), -(-ext_y // plan.sy))
        assert plan.window_bytes == gk._aligned(win.nbytes())
        assert rec["smem_bytes"] == plan.smem_bytes \
            == plan.window_bytes + plan.member_bytes
        assert f"constexpr int SMEM_MAX = {plan.smem_bytes};" in plan.source


@pytest.mark.parametrize("dtype", ["uint16", "int32"])
@pytest.mark.parametrize("case", ["bands8", "ragged_tail", "store_root",
                                  "narrow_tile"])
def test_band_walk_source_on_host_matches_golden(case, dtype, tmp_path):
    """The g++ build of the planned launch (the same blocks and staging as
    the card's, one thread a block; cp.async copies at once there) and the
    plain version equal the golden bit for bit."""
    img, pipe, out = _band_realize(case, dtype)
    gold = _band_golden(img)
    np.testing.assert_array_equal(out, gold)
    plan, inputs, rmins, params, _r = gk.group_call(pipe, "cpu")
    assert plan.record()["band_walk"] == BAND_CASES[case][5]
    assert any(k == "y" for w in plan.windows for k, _d, _o, _e in w.dims)
    assert "hl_stage_window<" in plan.source
    fn = _host_build(plan, tmp_path)
    host = torch.zeros(tuple(reversed(plan.extents)),
                       dtype=getattr(torch, dtype))
    assert fn(*gk.launch_args(plan, inputs, rmins, host)) == 0
    np.testing.assert_array_equal(host.numpy(), gold, err_msg=str(
        plan.record()))
    plain = gk.run_plain(plan, inputs, rmins, params, torch.device("cpu"))
    np.testing.assert_array_equal(plain.numpy(), gold)


def test_band_walk_cp_async_route_on_host(tmp_path):
    """linear_blur in 4 full-width bands is a band walk; its f32 window is
    staged by cp.async on the card, which the host build copies at once.
    Its store_root blur_x is computed whole in every sub-tile, as the
    planned launch of one sub-tile a block does."""
    app, data, out, (plan, inputs, rmins, _p, _r) = _group_call(
        "linear_blur", width=64, height=1024)
    rec = plan.record()
    assert rec["band_walk"] and rec["tile"] == (64, 256)
    assert rec["members"] == ["blur_x", "simple_blur"]
    assert rec["grid"] == rec["sub_tiles"]
    assert "hl_stage_window<float, 3>" in plan.source
    np.testing.assert_allclose(out, app.reference(**data), rtol=1e-4,
                               atol=1e-4)
    fn = _host_build(plan, tmp_path)
    host = torch.zeros(tuple(reversed(plan.extents)), dtype=torch.float32)
    assert fn(*gk.launch_args(plan, inputs, rmins, host)) == 0
    np.testing.assert_allclose(host.numpy(), out, rtol=1e-4, atol=1e-4)


def test_plain_version_over_some_sub_tile_rows():
    """run_plain over some sub-tile rows (the chip check holds the main
    path's full-size launches against it so) equals the whole plain
    version on the output rows that `plain_rows` names, the shifted-inwards
    last rows included."""
    _img, pipe, out = _band_realize("ragged_tail")
    plan, inputs, rmins, params, _r = gk.group_call(pipe, "cpu")
    n = plan.ncy
    rows = [0, 1, n - 2, n - 1]
    ys = gk.plain_rows(plan, rows)
    assert ys[0] == 0 and ys[-1] == plan.extents[plan.yi] - 1
    # the last sub-tile row is shifted inwards over the one before it
    assert 3 * plan.sy < len(ys) <= 4 * plan.sy < plan.extents[plan.yi]
    part = gk.run_plain(plan, inputs, rmins, params, torch.device("cpu"),
                        rows)
    np.testing.assert_array_equal(part.numpy()[ys], out[ys])


def test_member_buffers_share_shared_memory_by_liveness():
    """A chain of members: each buffer is free after the phase of its last
    reader, so the member region holds two live buffers, not the chain."""
    x, y = ht.Var("x"), ht.Var("y")
    xo, yo, xi, yi = ht.Var("xo"), ht.Var("yo"), ht.Var("xi"), ht.Var("yi")
    inp = ht.ImageParam(ht.Int(32), 2, "inp")
    chain = [ht.repeat_edge(inp)]
    for k in range(5):
        f = ht.Func(f"m{k}")
        f[x, y] = chain[-1][x - 1, y] + chain[-1][x + 1, y + 1] * 2
        chain.append(f)
    out = ht.Func("out")
    out[x, y] = chain[-1][x, y] - chain[-2][x, y]
    out.tile(x, y, xo, yo, xi, yi, 32, 16)
    for f in chain[1:]:
        f.compute_at(out, xo)
    a = np.random.default_rng(3).integers(-99, 99, (40, 64)).astype(np.int32)
    inp.set(torch.from_numpy(a))
    pipe = ht.Pipeline(out)
    got = pipe.realize([64, 40], device="cpu").to_numpy()
    plan = gk.group_call(pipe, "cpu")[0]
    sizes = [gk._aligned(m.nbytes()) for m in plan.members]
    assert plan.member_bytes < sum(sizes)
    # m3 is read by m4 and by the output: it stays live to the last phase
    live = {m.name: (m.smem_off, m.smem_off + s)
            for m, s in zip(plan.members, sizes)}
    for a_, b_ in (("m3", "m4"), ("m0", "m1"), ("m1", "m2")):
        (lo1, hi1), (lo2, hi2) = live[a_], live[b_]
        assert hi1 <= lo2 or hi2 <= lo1, (a_, b_, live)
    np.testing.assert_array_equal(got, _chain_golden(a))


def _chain_golden(a):
    """numpy of the member chain above, over the output box [0, 64) x
    [0, 40) with the input edge-clamped."""
    H, W = a.shape
    pad = 8
    cur = np.pad(a.astype(np.int64), pad, mode="edge")     # origin -pad
    vals = [cur]
    for _k in range(5):
        prev = vals[-1]
        nxt = np.zeros_like(prev)
        nxt[:-1, 1:-1] = prev[:-1, :-2] + prev[1:, 2:] * 2
        vals.append(nxt)
    o = vals[-1] - vals[-2]
    return o[pad:pad + H, pad:pad + W].astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["uint16", "int32"])
@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_band_walk_kernel_matches_plain_version_on_the_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    img = _band_input(case, dtype)
    by, sizes = _band_pipeline(ht, case, img, "cuda")
    pipe = ht.Pipeline(by)
    launches = gk.launches
    out = pipe.realize(sizes)
    assert gk.launches == launches + 1
    assert gk.last_plan["band_walk"] == BAND_CASES[case][5]
    plan, inputs, rmins, params, _realz = gk.group_call(pipe)
    plain = gk.run_plain(plan, inputs, rmins, params, inputs[0].device)
    torch.cuda.synchronize()
    assert torch.equal(out.data, plain)
    assert torch.equal(gk.launch(plan, inputs, rmins), plain), plan.record()
    np.testing.assert_array_equal(out.to_numpy(), _band_golden(img))


# ---------------------------------------------------------------------------
# saturating_cast and absd in the emitted source, and camera_pipe's tone
# curve over all of its 1,024 inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["sat_f32_u8", "sat_f32_i16", "sat_f32_i32",
                                  "sat_i32_u8", "sat_u16_i16", "absd_i16",
                                  "absd_i8", "absd_i16_in_u16_sum"])
def test_intrinsics_source_on_host_match_eval_jnp(case, tmp_path):
    """The g++ build of the group's source (hl_saturating_cast, hl_absd)
    and the plain version equal the JAX package's values bit for bit, NaN
    and the limits included."""
    from test_torch_eval import (INTRIN_CASES, IH, IW, intrin_inputs,
                                 intrin_pipeline, jax_intrin)
    a, b = intrin_inputs(INTRIN_CASES[case][1])
    ref = jax_intrin(case)
    pipe = intrin_pipeline(ht, case, a, b, tile=(8, 4))
    before = sum(gk.rejects.values())
    got = pipe.realize([IW, IH], device="cpu").to_numpy()
    assert sum(gk.rejects.values()) == before, dict(gk.rejects)
    np.testing.assert_array_equal(got, ref)
    plan, inputs, rmins, _p, _r = gk.group_call(pipe, "cpu")
    fn = _host_build(plan, tmp_path)
    host = torch.zeros(tuple(reversed(plan.extents)),
                       dtype=torch.from_numpy(got).dtype)
    assert fn(*gk.launch_args(plan, inputs, rmins, host)) == 0
    np.testing.assert_array_equal(host.numpy(), ref)


def _curve_pipeline(device="cpu"):
    """lut[x, y] = curve[x + 32 y] over 32 x 32: camera_pipe's inline tone
    curve at every raw value, tiled so that it goes through the group
    kernel (no members, no windows)."""
    from halide_tpu_torch.apps import camera_pipe
    x, y = ht.Var("x"), ht.Var("y")
    xo, yo, xi, yi = ht.Var("xo"), ht.Var("yo"), ht.Var("xi"), ht.Var("yi")
    curve = camera_pipe.tone_curve(x)
    lut = ht.Func("lut")
    lut[x, y] = curve[x + 32 * y]
    lut.tile(x, y, xo, yo, xi, yi, 16, 8)
    return ht.Pipeline(lut), camera_pipe.curve_lut().reshape(32, 32)


def test_tone_curve_source_on_host_matches_the_lut(tmp_path):
    """All 1,024 values of the tone curve (pow(x, 0.5), rounded to u8)
    through the g++ build of the group's source and through its plain
    version equal the golden's numpy LUT."""
    pipe, want = _curve_pipeline()
    before = sum(gk.rejects.values())
    got = pipe.realize([32, 32], device="cpu").to_numpy()
    assert sum(gk.rejects.values()) == before, dict(gk.rejects)
    np.testing.assert_array_equal(got, want)
    plan, inputs, rmins, _p, _r = gk.group_call(pipe, "cpu")
    assert plan.windows == [] and plan.members == []
    fn = _host_build(plan, tmp_path)
    host = torch.zeros((32, 32), dtype=torch.uint8)
    assert fn(*gk.launch_args(plan, inputs, rmins, host)) == 0
    np.testing.assert_array_equal(host.numpy(), want)


@pytest.mark.gpu
def test_tone_curve_kernel_matches_the_lut_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pipe, want = _curve_pipeline("cuda")
    launches = gk.launches
    got = pipe.realize([32, 32])
    assert gk.launches == launches + 1
    np.testing.assert_array_equal(got.to_numpy(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["sat_f32_u8", "sat_f32_i32", "sat_i32_u8",
                                  "sat_u16_i16", "absd_i16", "absd_i8"])
def test_intrinsics_kernel_match_plain_version_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from test_torch_eval import INTRIN_CASES, IH, IW, intrin_inputs, \
        intrin_pipeline
    a, b = intrin_inputs(INTRIN_CASES[case][1])
    pipe = intrin_pipeline(ht, case, a, b, tile=(8, 4), device="cuda")
    launches = gk.launches
    out = pipe.realize([IW, IH])
    assert gk.launches == launches + 1
    plan, inputs, rmins, params, _realz = gk.group_call(pipe)
    plain = gk.run_plain(plan, inputs, rmins, params, inputs[0].device)
    torch.cuda.synchronize()
    assert torch.equal(out.data, plain)


# ---------------------------------------------------------------------------
# the grid over the output extent (no output computed twice), a plan for
# Hopper's shared memory and threads, and the 16-byte window staging
# ---------------------------------------------------------------------------

def _ragged_pipeline(m, a_np, tile, device="cpu"):
    """A two-member i32 chain under a tile narrower than the output, as
    stencil_chain's anchors are (their extent is the tile plus the later
    stencils' reach): inp -> m1 -> m2 (compute_at) -> out (tiled)."""
    inp = m.ImageParam(m.Int(32), 2, "inp")
    x, y = m.Var("x"), m.Var("y")
    xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
    e = m.repeat_edge(inp)
    m1, m2, out = m.Func("m1"), m.Func("m2"), m.Func("out")
    m1[x, y] = e[x - 1, y] + e[x + 2, y + 1] * 3
    m2[x, y] = m1[x, y - 1] * 2 - m1[x + 1, y]
    out[x, y] = m2[x, y] + m2[x + 2, y + 1]
    out.tile(x, y, xo, yo, xi, yi, tile[0], tile[1])
    m1.compute_at(out, xo)
    m2.compute_at(out, xo)
    inp.set(torch.from_numpy(a_np).to(device) if m is ht else a_np)
    return m.Pipeline(out)


RAGGED = [(70, 50, (64, 32), (32, 16)), (70, 50, (64, 32), None),
          (45, 37, (40, 36), (32, 32))]


@pytest.mark.parametrize("w,h,tile,sub", RAGGED)
def test_ragged_tile_grid_covers_the_extent_once(w, h, tile, sub, tmp_path):
    """The output extent is not a multiple of the tile: the plan's grid is
    cdiv(extent, sx) x cdiv(extent_y, sy) sub-tiles (no output computed
    twice; the tiles x sub-tiles grid took cdiv(extent, tx) * cdiv(tx,
    sx) columns), and its plain version and the g++ build equal the JAX
    package's realize of the same pipeline (Pallas in interpret mode; the
    JAX planner partitions the ragged extent), bit for bit."""
    import halide_tpu as hl
    a = np.random.default_rng(8).integers(-500, 500, (h + 4, w + 4)) \
        .astype(np.int32)
    pipe = _ragged_pipeline(ht, a, tile)
    before = sum(gk.rejects.values())
    out = pipe.realize([w, h], device="cpu").to_numpy()
    assert sum(gk.rejects.values()) == before, dict(gk.rejects)
    ref = np.asarray(_ragged_pipeline(hl, a, tile).realize([w, h])
                     .to_numpy())
    np.testing.assert_array_equal(out, ref)
    replan = None if sub is None else (
        lambda p: [dict(sub_tile=sub, threads=128)])
    plan, inputs, rmins, params, _r = gk.group_calls(pipe, "cpu",
                                                     replan)[0]
    if sub is not None:
        assert (plan.sx, plan.sy) == sub
    assert plan.sx <= plan.tx and plan.sy <= plan.ty
    assert plan.record()["grid"] == (-(-w // plan.sx), -(-h // plan.sy))
    origins = list(gk._origins(plan))
    assert len(origins) == len(set(origins)) == plan.ncx * plan.ncy
    assert max(x0 for x0, _ in origins) == w - plan.sx
    np.testing.assert_array_equal(
        gk.run_plain(plan, inputs, rmins, params, torch.device("cpu"))
        .numpy(), ref)
    fn = _host_build(plan, tmp_path)
    host = torch.zeros((h, w), dtype=torch.int32)
    assert fn(*gk.launch_args(plan, inputs, rmins, host)) == 0
    np.testing.assert_array_equal(host.numpy(), ref)


def test_plan_above_48kb_with_512_threads_on_host(tmp_path):
    """A sub-tile whose shared memory passes 48 KB, at 512 threads a block
    (the card takes it as dynamic shared memory, up to 227 KB): the g++
    build of the same blocks equals the plain version point by point, and
    the emitted kernel carries the threads in __launch_bounds__."""
    _app, _data, out, (plan, *_x) = _group_call("linear_blur", width=200,
                                                height=160)
    app = _app
    (q, inputs, rmins, _p, _r), = gk.group_calls(
        app.pipeline, "cpu", lambda p: [dict(sub_tile=(64, 64),
                                             threads=512)])
    rec = q.record()
    assert rec["sub_tile"] == (64, 64) and rec["threads"] == 512
    assert 48 * 1024 < rec["smem_bytes"] <= gk._SMEM_LIMIT
    assert "constexpr int THREADS = 512;" in q.source
    assert "__launch_bounds__(THREADS, MIN_BLOCKS)" in q.source
    fn = _host_build(q, tmp_path)
    host = torch.zeros(tuple(reversed(q.extents)), dtype=torch.float32)
    assert fn(*gk.launch_args(q, inputs, rmins, host)) == 0
    plain = gk.run_plain(q, inputs, rmins, _p, torch.device("cpu"))
    np.testing.assert_allclose(host.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(plain.numpy(), out)


# (dtype, input width): row strides of 64 B (u8: 16-byte copies), 45 B (u8:
# by element), 104 B (u16: 8-byte copies), 148 B (f32: 4-byte copies) and
# 192 B (f32: 16-byte copies); the member reads x - 3 .. x + 2, so windows
# start off every alignment, and the blocks at the border leave the region
STAGE_CASES = [("uint8", 64), ("uint8", 45), ("uint16", 52),
               ("float32", 37), ("float32", 48)]


def _stage_pipeline(m, dtype, a_np, device="cpu"):
    t = {"uint8": m.UInt(8), "uint16": m.UInt(16),
         "float32": m.Float(32)}[dtype]
    inp = m.ImageParam(t, 2, "inp")
    x, y = m.Var("x"), m.Var("y")
    xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
    e = m.repeat_edge(inp)
    p, c = m.Func("p"), m.Func("c")
    wide = m.Float(32) if dtype == "float32" else m.Int(32)
    p[x, y] = m.cast(wide, e[x - 3, y]) + m.cast(wide, e[x + 2, y - 1]) * 2
    c[x, y] = p[x, y] - p[x + 1, y + 1]
    c.tile(x, y, xo, yo, xi, yi, 16, 8)
    p.compute_at(c, xo)
    inp.set(torch.from_numpy(a_np).to(device) if m is ht else a_np)
    return m.Pipeline(c)


def _stage_input(dtype, w, h=30):
    rng = np.random.default_rng(13)
    if dtype == "float32":
        return rng.uniform(-3, 3, (h, w)).astype(np.float32)
    return rng.integers(0, 250 if dtype == "uint8" else 60000, (h, w)) \
        .astype(dtype)


def _stage_golden(a):
    """c over [0, w) x [0, h) of the input edge-clamped, in i64 or f32."""
    h, w = a.shape
    wide = a.astype(np.float32 if a.dtype == np.float32 else np.int64)

    def e(xs, ys):
        return wide[np.clip(ys, 0, h - 1)[:, None], np.clip(xs, 0, w - 1)]

    def p(xs, ys):
        return e(xs - 3, ys) + e(xs + 2, ys - 1) * 2
    xs, ys = np.arange(w), np.arange(h)
    return p(xs, ys) - p(xs + 1, ys + 1)


@pytest.mark.parametrize("dtype,w", STAGE_CASES)
def test_window_staging_on_host_matches_plain_version(dtype, w, tmp_path):
    """The g++ build stages each window row by row in pieces of the copy
    unit (16, 8 or 4 bytes, or by element) where it lies inside the input,
    and element by element, edge-replicated, where it leaves it; both kinds
    of blocks occur, and the output equals the plain version and the
    golden."""
    a = _stage_input(dtype, w)
    pipe = _stage_pipeline(ht, dtype, a)
    before = sum(gk.rejects.values())
    out = pipe.realize([w, a.shape[0]], device="cpu").to_numpy()
    assert sum(gk.rejects.values()) == before, dict(gk.rejects)
    gold = _stage_golden(a)
    if dtype == "float32":
        np.testing.assert_allclose(out, gold, rtol=1e-6, atol=1e-5)
    else:
        np.testing.assert_array_equal(out, gold)
    plan, inputs, rmins, _p, _r = gk.group_calls(pipe, "cpu")[0]
    (win,) = plan.windows
    assert win.pitch() * gk.itemsize(win.type) % 16 == 0
    inside = []
    for x0, y0 in gk._origins(plan):
        box = gk._stage_box(win, x0, y0)
        inside.append(all(lo >= 0 and lo + ext <= n for (lo, ext), n in
                          zip(box, (w, a.shape[0]))))
    assert any(inside) and not all(inside)
    assert any(gk._stage_box(win, x0, y0)[0][0] % 16
               for x0, y0 in gk._origins(plan))
    fn = _host_build(plan, tmp_path)
    host = torch.zeros(out.shape, dtype=torch.from_numpy(out).dtype)
    assert fn(*gk.launch_args(plan, inputs, rmins, host)) == 0
    np.testing.assert_array_equal(host.numpy(), out)


@pytest.mark.gpu
@pytest.mark.parametrize("w,h,tile,sub", RAGGED)
def test_ragged_tile_kernel_matches_plain_version_on_the_card(w, h, tile,
                                                              sub):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = np.random.default_rng(8).integers(-500, 500, (h + 4, w + 4)) \
        .astype(np.int32)
    pipe = _ragged_pipeline(ht, a, tile, "cuda")
    launches = gk.launches
    out = pipe.realize([w, h])
    assert gk.launches == launches + 1
    replan = None if sub is None else (
        lambda p: [dict(sub_tile=sub, threads=128)])
    plan, inputs, rmins, params, _r = gk.group_calls(pipe, None, replan)[0]
    plain = gk.run_plain(plan, inputs, rmins, params, inputs[0].device)
    torch.cuda.synchronize()
    assert torch.equal(gk.launch(plan, inputs, rmins), plain)
    assert torch.equal(out.data, plain)


@pytest.mark.gpu
def test_plan_above_48kb_with_512_threads_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    app, _data = _torch_app("linear_blur", device="cuda", width=200,
                            height=160)
    app.realize()
    (q, inputs, rmins, params, _r), = gk.group_calls(
        app.pipeline, None, lambda p: [dict(sub_tile=(64, 64),
                                            threads=512)])
    assert q.record()["smem_bytes"] > 48 * 1024 and q.threads == 512
    plain = gk.run_plain(q, inputs, rmins, params, inputs[0].device)
    got = gk.launch(q, inputs, rmins)
    torch.cuda.synchronize()
    assert (got.double() - plain.double()).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,w", STAGE_CASES)
def test_window_staging_kernel_matches_plain_version_on_the_card(dtype, w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = _stage_input(dtype, w)
    pipe = _stage_pipeline(ht, dtype, a, "cuda")
    launches = gk.launches
    out = pipe.realize([w, a.shape[0]])
    assert gk.launches == launches + 1
    plan, inputs, rmins, params, _r = gk.group_call(pipe)
    plain = gk.run_plain(plan, inputs, rmins, params, inputs[0].device)
    torch.cuda.synchronize()
    assert torch.equal(out.data, plain)


# ---------------------------------------------------------------------------
# Let in a group, 16-bit floats in a group, and the async()/ring_buffer()
# request in the plan's record
# ---------------------------------------------------------------------------

def _let_pipeline(m, dtype, a_np, tile=(32, 16), device="cpu"):
    """chip_smoke.let_group (a member whose value is a hand-built expr.Let)
    on `a_np` converted to `dtype`, tiled: the group kernel's path."""
    import chip_smoke as cs
    if m is ht:
        a = torch.from_numpy(a_np).to(getattr(torch, dtype)).to(device)
    else:
        import jax.numpy as jnp
        a = jnp.asarray(a_np).astype(getattr(jnp, dtype))
    return cs.let_group(m, dtype, a, tile)


def _let_input(dtype, h=40, w=48):
    """int32 in [-300, 300); the floats k / 16 in [0.5, 2): every input is
    exact in a 16-bit float, a sum of two is exact, and every value is
    positive (see test_half_group_matches_jax)."""
    rng = np.random.default_rng(17)
    if dtype == "int32":
        return rng.integers(-300, 300, (h, w)).astype(np.int32)
    return (rng.integers(8, 32, (h, w)) / 16).astype(np.float32)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_let_group_matches_jax(dtype, tmp_path):
    """A member whose value is a Let: both packages' group plans take it
    (no reject), the emitted source binds the value once to a local that
    the body reads by name, and the g++ build, the plain version and the
    JAX package agree (bit for bit: the same f32 operations, no libm)."""
    import halide_tpu as hl
    from halide_tpu.ops import pallas_group as pg
    a = _let_input(dtype)
    pipe = _let_pipeline(ht, dtype, a)
    before = sum(gk.rejects.values())
    got = pipe.realize([48, 40], device="cpu").to_numpy()
    assert sum(gk.rejects.values()) == before, dict(gk.rejects)
    plan, inputs, rmins, _p, _r = gk.group_call(pipe, "cpu")
    assert plan.record()["members"] == ["p"]
    pg._last_plan = None
    ref = np.asarray(_let_pipeline(hl, dtype, a).realize([48, 40])
                     .to_numpy())
    assert pg._last_plan is not None          # the JAX group engaged
    np.testing.assert_array_equal(got, ref)
    fn = _host_build(plan, tmp_path)
    host = torch.zeros((40, 48), dtype=getattr(torch, dtype))
    assert fn(*gk.launch_args(plan, inputs, rmins, host)) == 0
    np.testing.assert_array_equal(host.numpy(), got)


def test_let_is_emitted_once_not_substituted():
    a = _let_input("int32")
    pipe = _let_pipeline(ht, "int32", a)
    pipe.realize([48, 40], device="cpu")
    plan = gk.group_call(pipe, "cpu")[0]
    # the two reads of the sum e[x - 1, y] + e[x + 1, y + 1] once, its
    # local read twice by the product and once by the final add
    import re
    body = plan.source.split("point_s")[1].split("return")[0]
    assert body.count("t.s0_inp[") == 2, body
    v = re.search(r"hl_mul<int32_t>\((t\d+), \1\)", body)
    assert v, body
    assert re.search(r"hl_add<int32_t>\(t\d+, %s\)" % v.group(1), body), body
    assert gk.point_ops(plan.members[0].value) == (0, 3)


def _ulps(got, ref, mant_bits):
    """|got - ref| in units of the last place of a float with `mant_bits`
    stored mantissa bits, at the larger magnitude of the two (values here
    are normal numbers)."""
    g, r = got.astype(np.float64), ref.astype(np.float64)
    mag = np.maximum(np.abs(g), np.abs(r))
    ulp = 2.0 ** (np.floor(np.log2(mag)) - mant_bits)
    return np.abs(g - r) / ulp


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_group_matches_jax(dtype, tmp_path):
    """A 16-bit float group (with its Let): the plan takes it, the g++ build
    equals the plain version bit for bit (each operation in f32, rounded to
    the type, as torch's ops on 16-bit tensors; the host stand-in rounds
    to nearest even as the card's instructions do). Against the JAX package
    within one unit in the last place of the type at any point: XLA's CPU
    computes a fused chain of 16-bit operations in f32 and rounds once where
    it stores (the member p, the output), where the port rounds after each
    operation. The inputs make that the only difference: v = a + b is exact
    (multiples of 1/16 below 4), so of v * v + v only the product is
    rounded early, by at most half a unit of the product, which is below
    the sum's; the final rounding then differs by at most one unit. max is
    exact, and every value is positive (no cancellation)."""
    import halide_tpu as hl
    a = _let_input(dtype)
    pipe = _let_pipeline(ht, dtype, a)
    before = sum(gk.rejects.values())
    out = pipe.realize([48, 40], device="cpu")
    assert sum(gk.rejects.values()) == before, dict(gk.rejects)
    plan, inputs, rmins, _p, _r = gk.group_call(pipe, "cpu")
    assert gk.ctype(plan.out_type) == {"float16": "hl_f16",
                                       "bfloat16": "hl_bf16"}[dtype]
    assert "hl_round16<" in plan.source
    fn = _host_build(plan, tmp_path)
    host = torch.zeros((40, 48), dtype=getattr(torch, dtype))
    assert fn(*gk.launch_args(plan, inputs, rmins, host)) == 0
    assert torch.equal(host.view(torch.int16), out.data.view(torch.int16))
    got = out.data.float().numpy()
    ref = np.asarray(_let_pipeline(hl, dtype, a).realize([48, 40])
                     .to_numpy()).astype(np.float32)
    assert _ulps(got, ref, 10 if dtype == "float16" else 7).max() <= 1.0


def test_half_literals_round_to_the_type():
    """A float literal in a 16-bit group is the value rounded to the type,
    as the plain version's constant tensor is."""
    for dtype, t in (("float16", ht.Float(16)), ("bfloat16", ht.BFloat(16))):
        lit = gk._float_lit(0.1, t)
        v = float(torch.tensor(0.1, dtype=getattr(torch, dtype)))
        assert lit == f"hl_round16<{gk.ctype(t)}>({v.hex()}f)", lit


def test_async_ring_buffer_plan_recorded():
    """tests/test_pallas.py:179 in both packages: async() and ring_buffer()
    on a member are recorded as requested; K1 answers with its one plan,
    one sub-tile a block with one window buffer, either way."""
    import halide_tpu as hl
    from halide_tpu.ops import pallas_group as pg
    W, H = 256, 64
    img = np.random.default_rng(3).integers(0, 1 << 12, (H, W), np.uint16)

    def build(m, asynchronous):
        x, y = m.Var("x"), m.Var("y")
        xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
        inp = m.Buffer(torch.from_numpy(img) if m is ht else img)
        bx, by = m.Func("ar_bx"), m.Func("ar_by")
        bx[x, y] = (inp[x, y] + inp[x + 1, y] + inp[x + 2, y]) / 3
        by[x, y] = (bx[x, y] + bx[x, y + 1] + bx[x, y + 2]) / 3
        by.tile(x, y, xo, yo, xi, yi, 64, 16).vectorize(xi).parallel(yo)
        bx.compute_at(by, xo)
        if asynchronous:
            bx.async_().ring_buffer(2)
        return by
    for asynchronous in (True, False):
        gk.last_plan = None
        got = build(ht, asynchronous).realize([W - 2, H - 2],
                                              device="cpu").to_numpy()
        rec = gk.last_plan
        pg._last_plan = None
        ref = np.asarray(build(hl, asynchronous).realize(
            [W - 2, H - 2], jit=False).to_numpy())
        assert rec["async_requested"] is pg._last_plan["async_requested"] \
            is asynchronous
        assert rec["grid"] == rec["sub_tiles"]
        np.testing.assert_array_equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int32", "float32", "float16",
                                   "bfloat16"])
def test_let_and_half_kernel_matches_plain_version_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = _let_input(dtype, 700, 1000)
    pipe = _let_pipeline(ht, dtype, a, (256, 128), "cuda")
    launches = gk.launches
    out = pipe.realize([1000, 700])
    assert gk.launches == launches + 1
    plan, inputs, rmins, params, _realz = gk.group_call(pipe)
    plain = gk.run_plain(plan, inputs, rmins, params, inputs[0].device)
    torch.cuda.synchronize()
    assert torch.equal(out.data, plain)

"""The stencil-group kernel (halide_tpu_torch/ops/group_kernel.py) on the
CPU: its plain version against the JAX package's group kernel (Pallas in
interpret mode) and against whole-array eval_torch, and the emitted CUDA
source compiled with the host C++ compiler against the plain version. The
kernel itself runs only on the card (the test marked gpu).

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
    so that a block's shared memory stays within the budget."""
    _app, _data, _out, call = _group_call("linear_blur", width=640,
                                          height=96)
    rec = call[0].record()
    assert rec["tile"] == (640, 96)
    sx, sy = rec["sub_tile"]
    assert sx <= 128 and sy <= 64 and rec["smem_bytes"] <= gk._SMEM_TARGET
    assert rec["members"] == ["blur_x", "simple_blur"]
    assert rec["windows"] == ["srgb_to_linear"]


@pytest.mark.parametrize("name,kw", [
    ("blur", dict(width=96, height=64, tile=(40, 24))),
    ("linear_blur", dict(width=64, height=48)),
])
def test_emitted_source_on_host_matches_plain_version(name, kw, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the emitted source")
    _app, _data, out, (plan, inputs, rmins, _p, _r) = _group_call(name,
                                                                   **kw)
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
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the emitted source")
    _a, pipe, out = _div_realize(form, dtype, w, h, tile)
    plan, inputs, rmins, _p, _r = gk.group_call(pipe, "cpu")
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

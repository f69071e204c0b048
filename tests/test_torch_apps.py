"""The apps of the port against the JAX package's apps and their numpy
goldens, on the CPU at the small sizes of tests/test_apps.py, with its
comparison rules: bit for bit where the app's tolerance is 0 (blur, u16),
else within the app's rtol/atol (linear_blur: 1e-4, which covers the two
libms' pow and XLA's fused multiply-adds; iir_blur: 2e-3; hist: atol 2, for
the float Y that may fall into a neighbouring bin where it lies within an
ulp of an integer; interpolate: 2e-3; local_laplacian: u16 within 2 steps
on all but 0.3% of the pixels, the rule of tests/test_apps.py for its
int-cast boundaries)."""
import numpy as np
import pytest
import torch

from halide_tpu.apps import get as jax_get
from halide_tpu_torch.apps import get as torch_get
from halide_tpu_torch.apps import inputs_from_numpy
from halide_tpu_torch.ops import group_kernel as gk
from halide_tpu_torch.ops import rowhist_kernel

SMALL = dict(width=96, height=64)


def _compare(app, got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if app.tolerance == 0.0 and app.atol == 0.0:
        np.testing.assert_array_equal(got, want)
    elif app.mismatch_frac > 0:
        gf, wf = got.astype(np.float64), want.astype(np.float64)
        bad = np.abs(gf - wf) > app.atol + app.tolerance * np.abs(wf)
        assert bad.mean() <= app.mismatch_frac, (
            f"{bad.mean():.4%} of pixels mismatch "
            f"(> {app.mismatch_frac:.4%})")
    else:
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64),
                                   rtol=app.tolerance, atol=app.atol)


def _run_both(name, monkeypatch, jax_env=None, seed=0, **kw):
    tapp = torch_get(name)(**kw)
    data = tapp.make_inputs(seed)
    tapp.bind(data, "cpu")
    got = tapp.realize("cpu").to_numpy()
    if jax_env:
        for k, v in jax_env.items():
            monkeypatch.setenv(k, v)
    jkw = {k: v for k, v in kw.items()
           if k not in ("tile", "kernel", "slide", "roots")}
    japp = jax_get(name)(**jkw)
    jdata = japp.make_inputs(seed)
    for k in data:
        np.testing.assert_array_equal(data[k], jdata[k])  # same inputs
    japp.bind(jdata)
    want = np.asarray(japp.realize().to_numpy())
    return tapp, data, got, want


def test_blur_untiled(monkeypatch):
    app, data, got, want = _run_both("blur", monkeypatch, **SMALL)
    _compare(app, got, want)
    _compare(app, got, app.reference(**data))


@pytest.mark.parametrize("tile", [(32, 16), (40, 24)])
def test_blur_tiled(tile, monkeypatch):
    launches, rejects = gk.launches, sum(gk.rejects.values())
    gk.last_plan = None
    app, data, got, want = _run_both(
        "blur", monkeypatch, {"HALIDE_TPU_BLUR_TILE": f"{tile[0]}x{tile[1]}"},
        tile=tile, **SMALL)
    assert gk.last_plan is not None and gk.last_plan["func"] == "blur_y"
    assert gk.launches == launches and sum(gk.rejects.values()) == rejects
    _compare(app, got, want)
    _compare(app, got, app.reference(**data))


@pytest.mark.parametrize("seed", [0, 1])
def test_linear_blur(seed, monkeypatch):
    rejects = sum(gk.rejects.values())
    gk.last_plan = None
    app, data, got, want = _run_both("linear_blur", monkeypatch, seed=seed,
                                     width=64, height=48)
    assert gk.last_plan is not None
    assert gk.last_plan["func"] == "linear_to_srgb"
    assert sum(gk.rejects.values()) == rejects
    _compare(app, got, want)
    _compare(app, got, app.reference(**data))


def test_inputs_from_numpy_moves_image_inputs():
    app = torch_get("linear_blur")(width=16, height=8)
    data = app.make_inputs(0)
    moved = inputs_from_numpy(app, data, "cpu")
    t = moved["input"]
    assert isinstance(t, torch.Tensor) and t.is_contiguous()
    assert t.dtype == torch.float32 and tuple(t.shape) == (3, 8, 16)
    np.testing.assert_array_equal(t.numpy(), data["input"])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["iir_blur", "hist"])
def test_update_definition_apps(name, seed, monkeypatch):
    app, data, got, want = _run_both(name, monkeypatch, seed=seed, **SMALL)
    _compare(app, got, want)
    _compare(app, got, app.reference(**data))


def test_hist_through_the_row_histogram_route(monkeypatch):
    """At 640 pixels a row, hist_rows takes K3's route (its plain version
    on the CPU)."""
    calls = []
    orig = rowhist_kernel.rowhist

    def spy(lin2d, K, scale=1.0):
        calls.append((tuple(lin2d.shape), K, scale))
        return orig(lin2d, K, scale)

    monkeypatch.setattr(rowhist_kernel, "rowhist", spy)
    app, data, got, want = _run_both("hist", monkeypatch, width=640,
                                     height=300)
    assert calls == [((300, 640), 256, 1.0)]
    _compare(app, got, want)
    _compare(app, got, app.reference(**data))


@pytest.fixture
def one_torch_thread():
    """local_laplacian runs on one torch thread on the CPU. Its remap
    takes torch.exp of a whole 8-plane pyramid level, and torch's CPU exp
    (torch 2.13.0+cpu, with MKL), on its first call in a process, can
    return values off by ~1e-4 on one or two worker threads' shares of the
    elements with 8 threads, never with one; the same call again is right.
    `tools/cpu_exp_witness.py` shows this with torch.exp alone. It moves
    the u16 output past the app's mismatch rule now and then. The card's
    expf is not involved."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kernel_branch(name, monkeypatch, jax_env, tile, **kw):
    """The port's tiled branch (the plan taken, no reject) against the
    JAX app and the golden, under the app's own rule."""
    rejects = sum(gk.rejects.values())
    gk.last_plan = None
    app, data, got, want = _run_both(name, monkeypatch, jax_env, tile=tile,
                                     **kw)
    assert sum(gk.rejects.values()) == rejects, dict(gk.rejects)
    assert gk.last_plan is not None
    assert gk.last_plan["func"] == app.pipeline.outputs[0].name
    _compare(app, got, want)
    _compare(app, got, app.reference(**data))
    return gk.last_plan


@pytest.mark.parametrize("w,h,levels,tile", [
    (96, 64, 5, (32, 16)), (512, 128, 6, (256, 64)), (512, 128, 6, (32, 16))])
def test_interpolate_kernel_branch(w, h, levels, tile, monkeypatch):
    plan = _kernel_branch("interpolate", monkeypatch,
                          {"HALIDE_TPU_IP_KERNEL": "1"}, tile, width=w,
                          height=h, levels=levels)
    assert plan["members"] == ["interp_0"]
    assert plan["div_windows"] == {"interp_1": [("x", 2), ("y", 2)]}


@pytest.mark.parametrize("w,h,levels,tile", [
    (96, 64, 4, (32, 16)), (512, 128, 5, (256, 64)), (512, 128, 5, (32, 16))])
def test_local_laplacian_kernel_branch(w, h, levels, tile, monkeypatch,
                                       one_torch_thread):
    plan = _kernel_branch("local_laplacian", monkeypatch,
                          {"HALIDE_TPU_LL_KERNEL": "1"}, tile, width=w,
                          height=h, pyramid_levels=levels)
    assert plan["members"] == ["lPyramid_0", "outGPyramid_0"]
    assert plan["div_windows"] == {"outGPyramid_1": [("x", 2), ("y", 2)],
                                   "gPyramid_1": [("x", 2), ("y", 2)]}


def test_local_laplacian_level_select_reads_a_static_plane_range(
        monkeypatch, one_torch_thread):
    """lPyramid[0] is read at the data-dependent plane li and li + 1, li
    clamped to [0, levels - 2]: the member is staged over all `levels`
    planes, a static dim."""
    tapp = torch_get("local_laplacian")(width=96, height=64,
                                        pyramid_levels=4, levels=6,
                                        tile=(32, 16))
    tapp.bind(tapp.make_inputs(0), "cpu")
    got = tapp.realize("cpu").to_numpy()
    plan = gk.group_call(tapp.pipeline, "cpu")[0]
    lp = next(m for m in plan.members if m.name == "lPyramid_0")
    assert lp.dims[2] == ("s", 1, 0, 6)
    _compare(tapp, got, tapp.reference(**tapp.make_inputs(0)))


@pytest.mark.parametrize("name,kw", [
    ("interpolate", dict(width=96, height=64, levels=5)),
    ("local_laplacian", dict(width=96, height=64, pyramid_levels=4)),
])
def test_pyramid_apps_root_branch(name, kw, monkeypatch, one_torch_thread):
    """tile=None: the full-resolution level computed at root, whole-array
    (the div-indexed reads of the half-resolution level as slices)."""
    gk.last_plan = None
    app, data, got, want = _run_both(name, monkeypatch, tile=None, **kw)
    assert gk.last_plan is None
    _compare(app, got, want)
    _compare(app, got, app.reference(**data))


def test_pyramid_apps_default_tile():
    """Full widths by default, and the canonical 256x64 tile where the
    sizes divide; else the root branch."""
    from halide_tpu_torch.apps import interpolate, local_laplacian
    for mod in (interpolate, local_laplacian):
        app = mod.build()
        assert app.output_sizes == [1536, 2560, 3]
        tiled = mod.build(width=512, height=128).pipeline.outputs[0]
        assert gk.find_tile(tiled) == ("x", 256, "y", 64)
        root = mod.build(width=96, height=64).pipeline.outputs[0]
        assert gk.find_tile(root) is None


def _groups_of(name, monkeypatch, jax_env, **kw):
    """The port's realize (counting the groups that ran through the plan
    and its plain version) against the JAX app under `jax_env` and the
    golden, bit for bit. -> the plan record of each group, in order."""
    recs = []
    orig = gk.run_plain

    def spy(plan, *a, **k):
        recs.append(plan.record())
        return orig(plan, *a, **k)

    monkeypatch.setattr(gk, "run_plain", spy)
    rejects = sum(gk.rejects.values())
    app, data, got, want = _run_both(name, monkeypatch, jax_env, **kw)
    assert sum(gk.rejects.values()) == rejects, dict(gk.rejects)
    _compare(app, got, want)
    _compare(app, got, app.reference(**data))
    return recs


# (w, h, stencils, build arguments, JAX env, the groups' band walks)
STENCIL_CHAIN_CASES = [
    (256, 128, 12, {}, None, []),
    (256, 128, 12, {"kernel": True}, {"HALIDE_TPU_SC_KERNEL": "1"},
     [False, False]),
    (256, 512, 12, {"kernel": True}, {"HALIDE_TPU_SC_KERNEL": "1"},
     [False, True]),
    (256, 128, 12, {"slide": 128}, {"HALIDE_TPU_SC_SLIDE": "128"},
     [False, False]),
    (256, 512, 12, {"slide": 128}, {"HALIDE_TPU_SC_SLIDE": "128"},
     [False, False]),
]


@pytest.mark.parametrize("w,h,n,kw,env,walks", STENCIL_CHAIN_CASES)
def test_stencil_chain(w, h, n, kw, env, walks, monkeypatch):
    """Whole-array, the kernel branch (one group per 8 stencils in bands
    of the output's width: the first anchor, wider by the reach of the
    stencils after it, takes two tiles across and is no band walk; the
    last is one at 4 bands) and the slide branch (narrower tiles: no band
    walk; the producers stored at the row loop, computed whole in every
    sub-tile as any member: tests/test_torch_sliding.py)."""
    recs = _groups_of("stencil_chain", monkeypatch, env, width=w, height=h,
                      stencils=n, **kw)
    assert [r["band_walk"] for r in recs] == walks
    assert [r["func"] for r in recs] == ["stage_7", "stage_11"][:len(walks)]
    for r in recs:
        stencils = 8 if r["func"] == "stage_7" else 4
        assert len(r["members"]) == 2 * stencils - 1


# (w, h, build arguments, JAX env, the group's band walk or None)
CAMERA_PIPE_CASES = [
    (512, 128, {}, None, None),
    (512, 128, {"roots": "deinterleaved,g_r,g_b,curved"},
     {"HALIDE_TPU_CP_ROOTS": "deinterleaved,g_r,g_b,curved"}, None),
    (512, 128, {"kernel": True}, {"HALIDE_TPU_CP_KERNEL": "1"}, False),
    (512, 512, {"kernel": True, "tile": (512, 128)},
     {"HALIDE_TPU_CP_KERNEL": "1", "HALIDE_TPU_CP_TILE": "512x128"}, True),
]


@pytest.mark.parametrize("w,h,kw,env,walk", CAMERA_PIPE_CASES)
def test_camera_pipe(w, h, kw, env, walk, monkeypatch):
    """Bit-exact u8: the whole-array branch (its root set as an argument)
    and the kernel branch, whose full-width 512x128 tile walks 4 bands."""
    recs = _groups_of("camera_pipe", monkeypatch, env, out_width=w,
                      out_height=h, **kw)
    assert [r["band_walk"] for r in recs] == ([] if walk is None
                                              else [walk])
    for r in recs:
        assert r["members"] == ["demosaiced", "curved", "unsharp_y"]
        assert set(r["div_windows"]) == {"deinterleaved", "g_r", "g_b"}


def test_camera_pipe_roots_name_a_stage():
    from halide_tpu_torch import CompileError
    from halide_tpu_torch.apps import camera_pipe
    with pytest.raises(CompileError, match="unknown stage 'nope'"):
        camera_pipe.build(out_width=64, out_height=32, roots="g_r,nope")


# ---------------------------------------------------------------------------
# unsharp, harris and wavelet: their default schedules (compute_root only,
# whole-array), and unsharp's and harris's tiled schedules, put on both
# packages' pipelines from outside by the same code (tile_producers)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["unsharp", "harris", "wavelet"])
def test_whole_array_apps(name, seed, monkeypatch):
    gk.last_plan = None
    app, data, got, want = _run_both(name, monkeypatch, seed=seed, **SMALL)
    assert gk.last_plan is None
    _compare(app, got, want)
    _compare(app, got, app.reference(**data))


def _tiled_both(name, tile, seed=0, **kw):
    """The app with its output tiled by `tile` and its wide producers at
    the tiles, in both packages (the JAX side with its group kernel in
    interpret mode, as the repo's CPU settings run it). -> (app, data,
    port output, JAX output, the JAX planner's record or None)."""
    import halide_tpu as hl
    import halide_tpu_torch as ht
    from halide_tpu.ops import pallas_group
    from halide_tpu_torch.apps import TILED_PRODUCERS, tile_producers
    tapp = torch_get(name)(**kw)
    tile_producers(ht, tapp.pipeline, tile, TILED_PRODUCERS[name])
    data = tapp.make_inputs(seed)
    tapp.bind(data, "cpu")
    got = tapp.realize("cpu").to_numpy()
    japp = jax_get(name)(**kw)
    tile_producers(hl, japp.pipeline, tile, TILED_PRODUCERS[name])
    japp.bind(japp.make_inputs(seed))
    pallas_group._last_plan = None
    want = np.asarray(japp.realize().to_numpy())
    return tapp, data, got, want, pallas_group._last_plan


@pytest.mark.parametrize("tile", [(32, 16), (40, 24)])
@pytest.mark.parametrize("name", ["unsharp", "harris"])
def test_tiled_apps_go_through_the_group_plan(name, tile):
    """The port's plan takes the tiled group (no reject; the output is the
    group's consumer, the wide producers its members); the JAX planner
    takes it too at these sizes (recorded: its _last_plan). The values
    against the JAX package and the golden, under the app's rule."""
    from halide_tpu_torch.apps import TILED_PRODUCERS
    rejects = sum(gk.rejects.values())
    gk.last_plan = None
    app, data, got, want, jax_plan = _tiled_both(name, tile, **SMALL)
    assert sum(gk.rejects.values()) == rejects, dict(gk.rejects)
    assert gk.last_plan["func"] == app.pipeline.outputs[0].name
    assert gk.last_plan["members"] == list(TILED_PRODUCERS[name])
    assert gk.last_plan["windows"] == ["input"]
    assert jax_plan is not None and jax_plan["grid"]
    _compare(app, got, want)
    _compare(app, got, app.reference(**data))


def test_harris_compute_with_and_bounds_match_jax():
    """harris's Ix.compute_with(Iy, x) and its output shifted by +3 and
    realized over [width - 6, height - 6]: the regions bounds inference
    gives gray, Ix and Iy (each package's _BoundsPass) are the same."""
    import halide_tpu as hl
    import halide_tpu_torch as ht
    from halide_tpu import bounds as hb
    from halide_tpu import pipeline as hp
    from halide_tpu_torch import bounds as tb
    from halide_tpu_torch import pipeline as tp
    regions = {}
    for m, pmod, bmod, get in ((hl, hp, hb, jax_get),
                               (ht, tp, tb, torch_get)):
        app = get("harris")(**SMALL)
        out = app.pipeline.outputs[0]
        g = pmod.gather_graph([out])
        bp = pmod._BoundsPass(g, bmod.BoundsEngine())
        w, h = app.output_sizes
        bp.run([out], {id(out): bmod.Box([bmod.Interval(0, w - 1),
                                          bmod.Interval(0, h - 1)])})
        regions[m] = {f.name: [(d.lo, d.hi) for d in bp.boxes[id(f)].dims]
                      for f in g.funcs if f.name in ("gray", "Ix", "Iy")}
    assert regions[ht] == regions[hl]
    assert regions[ht]["gray"] == [(1, 94), (1, 62)]
    assert regions[ht]["Ix"] == regions[ht]["Iy"] == [(2, 93), (2, 61)]



# ---------------------------------------------------------------------------
# the apps of inline reductions and contraction updates: the sizes of
# tests/test_apps.py, each against the JAX app and its golden under the
# app's rule (gaussian_blur 1e-4 / 1e-5, max_filter bit for bit, conv_layer
# and depthwise_separable_conv 1e-3 / 1e-2, nl_means 1e-3, the linear
# algebra ops and fft their own)
# ---------------------------------------------------------------------------

REDUCTION_APPS = [
    ("gaussian_blur", dict(width=96, height=64)),
    ("max_filter", dict(width=48, height=40, radius=6)),
    ("conv_layer", dict(N=2, CI=32, CO=32, W=32, H=16)),
    ("depthwise_separable_conv", dict(N=2, CI=16, CO=8, CM=1, W=32, H=24)),
    ("nl_means", dict(width=48, height=40, patch_size=5, search_area=5)),
    ("sgemm", dict(M=128, N=96, K=64)),
    ("sgemm", dict(M=64, N=64, K=48, transpose_A=True, transpose_B=True)),
    ("sgemm_tn", dict(M=96, N=80, K=64)),
    ("sgemm_nt", dict(M=96, N=80, K=64)),
    ("dgemm", dict(M=64, N=96, K=48)),
    ("hgemm", dict(M=128, N=96, K=64)),
    ("sgemv", dict(M=64, N=128)),
    ("saxpy", dict(N=1000)),
    ("sdot", dict(N=4096)),
    ("sscal_scopy", dict(N=1000)),
    ("sasum", dict(N=4096)),
    ("sger", dict(M=64, N=96)),
    ("fft", dict(width=64, height=32)),
]


def _outputs(r):
    if isinstance(r, (list, tuple)) or type(r).__name__ == "Realization":
        return [np.asarray(b.to_numpy()) for b in r]
    return [np.asarray(r.to_numpy())]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,kw", REDUCTION_APPS,
                         ids=[f"{n}-{i}" for i, (n, _k) in
                              enumerate(REDUCTION_APPS)])
def test_reduction_apps(name, kw, seed):
    tapp = torch_get(name)(**kw)
    data = tapp.make_inputs(seed)
    tapp.bind(data, "cpu")
    got = _outputs(tapp.realize("cpu"))
    japp = jax_get(name)(**kw)
    jdata = japp.make_inputs(seed)
    for k in data:
        np.testing.assert_array_equal(data[k], jdata[k])
    japp.bind(jdata)
    want = _outputs(japp.realize())
    ref = tapp.reference(**data)
    refs = list(ref) if isinstance(ref, (list, tuple)) else [ref]
    assert len(got) == len(want) == len(refs)
    for g, w, r in zip(got, want, refs):
        _compare(tapp, g, w)
        _compare(tapp, g, np.asarray(r, dtype=g.dtype))


@pytest.mark.parametrize("seed", [0, 1])
def test_nl_means_box_sums_through_the_group_kernel(seed, monkeypatch):
    """nl_means at 256 x 64, patch 5, search 5 (tests/test_pallas.py:505):
    its three 4-D box sums (d, blur_d_y and blur_d, each an hl.sum) are one
    K1 group with no rejected plan, as the JAX package's group kernel
    engages (a spy on its try_pallas_group); the output meets the JAX app
    and its golden, 1e-3."""
    from halide_tpu.ops import pallas_group
    monkeypatch.setenv("HALIDE_TPU_NLM_KERNEL", "1")
    calls = []
    orig = pallas_group.try_pallas_group

    def spy(*a, **kw):
        r = orig(*a, **kw)
        calls.append(r is not None)
        return r
    monkeypatch.setattr(pallas_group, "try_pallas_group", spy)
    rejects = sum(gk.rejects.values())
    gk.last_plan = None
    app, data, got, want = _run_both("nl_means", monkeypatch, seed=seed,
                                     width=256, height=64, patch_size=5,
                                     search_area=5)
    assert calls == [True]
    assert sum(gk.rejects.values()) == rejects, dict(gk.rejects)
    assert gk.last_plan["func"] == "blur_d"
    assert gk.last_plan["tile"] == (256, 64)
    assert gk.last_plan["members"] == ["d", "blur_d_y"]
    assert gk.last_plan["windows"] == ["input"]
    _compare(app, got, want)
    _compare(app, got, app.reference(**data))


# ---------------------------------------------------------------------------
# the last image apps: compositing, bilateral_grid, bgu, resize, lens_blur
# (tests/test_apps.py:76, 109, 113, 118, 123, 140, 190)
# ---------------------------------------------------------------------------

LENS_SMALL = dict(width=48, height=40, slices=8, focus_depth=4,
                  aperture_samples=4, levels=4)


@pytest.mark.parametrize("name,kw,seed", [
    ("compositing", dict(width=64, height=48), 0),
    ("bilateral_grid", dict(width=64, height=48), 0),
    ("bilateral_grid", dict(width=64, height=48), 1),
    ("bgu", dict(width=128, height=96), 0),
    ("bgu", dict(width=128, height=96), 1),
    ("lens_blur", dict(LENS_SMALL, blur_radius_scale=0.0), 0),
])
def test_last_image_apps(name, kw, seed, monkeypatch):
    """compositing and bilateral_grid at these sizes whole-array (their
    tiles do not divide them), bgu with its tile clamped to the extent,
    lens_blur's zero-radius case (output == left / 255): against the JAX
    app and the golden, under the app's own rule (compositing bit for
    bit)."""
    app, data, got, want = _run_both(name, monkeypatch, seed=seed, **kw)
    _compare(app, got, want)
    _compare(app, got, app.reference(**data))


def _jax_engages(name, monkeypatch, env=None, **kw):
    """The JAX app's realize with a spy on its group kernel (as
    tests/test_pallas.py:85-115). -> (output, engaged per group call)."""
    from halide_tpu.ops import pallas_group
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    calls = []
    orig = pallas_group.try_pallas_group

    def spy(*a, **k):
        r = orig(*a, **k)
        calls.append(r is not None)
        return r
    monkeypatch.setattr(pallas_group, "try_pallas_group", spy)
    japp = jax_get(name)(**kw)
    japp.bind(japp.make_inputs(0))
    return np.asarray(japp.realize().to_numpy()), calls


@pytest.mark.parametrize("name,kw,env,members,windows", [
    ("compositing", dict(width=512, height=128),
     {"HALIDE_TPU_CO_KERNEL": "1"}, ["blended"],
     ["ops"] + [f"layer_{i}" for i in range(6)]),
    ("bilateral_grid", dict(width=512, height=256), None, ["interpolated"],
     ["blury", "input"]),
])
def test_tiled_image_apps_go_through_the_group_kernel(
        name, kw, env, members, windows, monkeypatch):
    """compositing at 512x128 (tests/test_pallas.py:172: the tuple-valued
    `blended` with its masked 5x5 update chain a member) and
    bilateral_grid at 512x256 (tests/test_pallas.py:121: the trilinear
    slice, blury a window with x / 8 and y / 8 dims): the port's plan
    takes the group, with no reject, where the JAX kernel engages, and
    the output meets the JAX app and the golden (compositing bit for
    bit)."""
    rejects = sum(gk.rejects.values())
    gk.last_plan = None
    tapp = torch_get(name)(**kw)
    data = tapp.make_inputs(0)
    tapp.bind(data, "cpu")
    got = tapp.realize("cpu").to_numpy()
    assert sum(gk.rejects.values()) == rejects, dict(gk.rejects)
    assert gk.last_plan["func"] == tapp.pipeline.outputs[0].name
    assert gk.last_plan["members"] == members
    assert gk.last_plan["windows"] == windows
    want, engaged = _jax_engages(name, monkeypatch, env, **kw)
    assert engaged == [True]
    _compare(tapp, got, want)
    _compare(tapp, got, tapp.reference(**data))


def test_bgu_slice_group_plan():
    """bgu's slice at 512x256, tile 512x256 (the JAX app's default): one
    group, imz and interpolated its members, the coarse `line` table a
    window whose x dim is read at x / 64 (big_sigma: s_sigma 8 times the
    upsample 8), and slice_loc; the output within the app's rule of its
    golden. imz="inline" makes imz part of interpolated's point
    function."""
    app = torch_get("bgu")(width=512, height=256)
    data = app.make_inputs(0)
    app.bind(data, "cpu")
    rejects = sum(gk.rejects.values())
    got = app.realize("cpu").to_numpy()
    assert sum(gk.rejects.values()) == rejects, dict(gk.rejects)
    rec = gk.last_plan
    assert rec["members"] == ["bgu_imz", "bgu_interp"]
    assert rec["windows"] == ["bgu_line", "slice_loc"]
    assert ("x", 64) in rec["div_windows"]["bgu_line"]
    _compare(app, got, app.reference(**data))
    inline = torch_get("bgu")(width=512, height=256, imz="inline")
    inline.bind(data, "cpu")
    _compare(inline, inline.realize("cpu").to_numpy(), got)
    assert gk.last_plan["members"] == ["bgu_interp"]


@pytest.mark.parametrize("kw,einsums", [
    (dict(width=96, height=64, scale_factor=0.5), 0),
    (dict(width=48, height=32, scale_factor=2.0, interpolation="linear",
          upsample=True), 0),
    (dict(width=256, height=160, scale_factor=0.5), 2)])
def test_resize(kw, einsums, monkeypatch):
    """resize's four hl.sum stages: the two kernel normalizations (one
    factor) take the evaluator's plain reduce in both packages, and so do
    the two full-width tap sums below the einsum path's grid of 2^22
    points; at 256x160 their grids pass it, and both packages contract
    them by einsum (a spy on the JAX package's try_conv_reduce /
    try_einsum_reduce; eval_torch.reduce_paths). The output against the
    JAX app and the golden."""
    from halide_tpu import eval_jnp
    from halide_tpu_torch import eval_torch
    from halide_tpu_torch import updates as tupdates
    tries = []
    for fname in ("try_conv_reduce", "try_einsum_reduce"):
        orig = getattr(eval_jnp, fname)

        def spy(*a, _orig=orig, _name=fname, **k):
            r = _orig(*a, **k)
            tries.append((_name, r is not None))
            return r
        monkeypatch.setattr(eval_jnp, fname, spy)
    before = dict(eval_torch.reduce_paths)
    tupdates._last_reduce_path.clear()
    app, data, got, want = _run_both("resize", monkeypatch, **kw)
    paths = {k: v - before.get(k, 0)
             for k, v in eval_torch.reduce_paths.items()
             if v != before.get(k, 0)}
    assert paths == {k: v for k, v in (("reduce", 4 - einsums),
                                       ("einsum", einsums)) if v}
    assert tupdates._last_reduce_path == {}
    jax_einsums = [ok for name, ok in tries if name == "try_einsum_reduce"]
    assert ("try_conv_reduce", True) not in tries
    assert len(jax_einsums) == 4 and sum(jax_einsums) == einsums
    _compare(app, got, want)
    _compare(app, got, app.reference(**data))


def test_lens_blur_stochastic_against_jax(monkeypatch):
    """blur_radius_scale 0.5: the aperture samples come from random_float,
    which the port draws as the JAX package does, bit for bit, so the
    stochastic output meets the JAX app's within the app's tolerance
    (1e-4); and the structural checks of tests/test_apps.py:123. Its
    `bokeh_w += 1.0` scatter adds whole numbers below 2^24 in f32: exact
    in any order."""
    app, data, got, want = _run_both("lens_blur", monkeypatch,
                                     **dict(LENS_SMALL,
                                            blur_radius_scale=0.5))
    assert app.reference(**data) is None
    assert got.shape == (3, 40, 48) and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 255.0
    _compare(app, got, want)


def test_last_image_apps_default_schedules():
    """The JAX apps' defaults as keyword arguments: compositing and
    bilateral_grid tiled where the sizes divide (256x128 and 512x256),
    bgu tiled 512x256 clamped to the extent (with a floor of 8); else
    compositing untiled and bilateral_grid's slice at root."""
    from halide_tpu_torch.apps import bgu, bilateral_grid, compositing
    assert gk.find_tile(compositing.build().pipeline.outputs[0]) == (
        "x", 256, "y", 128)
    assert gk.find_tile(compositing.build(kernel=False)
                        .pipeline.outputs[0]) is None
    assert gk.find_tile(compositing.build(64, 48).pipeline.outputs[0]) \
        is None
    assert gk.find_tile(bilateral_grid.build().pipeline.outputs[0]) == (
        "x", 512, "y", 256)
    assert gk.find_tile(bilateral_grid.build(64, 48)
                        .pipeline.outputs[0]) is None
    assert gk.find_tile(bgu.build(width=128, height=96).pipeline
                        .outputs[0]) == ("x", 128, "y", 96)
    assert gk.find_tile(bgu.build(tile=None).pipeline.outputs[0]) is None


def _fractional_slice(m):
    """tests/test_correctness_misc.py:352: a table read at a data-dependent
    index i and i + 1, i clamped to [0, 3] (reaching its last plane), with
    a fractional weight. -> the output."""
    x, z = m.Var("x"), m.Var("z")
    tbl = m.Func("fs_tbl")
    tbl[z] = m.f32(z) * 10.0
    tbl.compute_root()
    vals = np.array([0.25, 1.5, 3.5, 3.75, 2.0], np.float32)
    inp = m.Buffer(torch.from_numpy(vals) if m.__name__ ==
                   "halide_tpu_torch" else vals)
    f = m.Func("fs_out")
    iv = m.clamp(m.i32(inp[x]), 0, 3)
    w = inp[x] - m.f32(m.i32(inp[x]))
    f[x] = (1.0 - w) * tbl[iv] + w * tbl[iv + 1]
    kw = {"device": "cpu"} if m.__name__ == "halide_tpu_torch" else {}
    return np.asarray(f.realize([5], **kw).to_numpy()), vals


def test_fractional_slice_top_plane_clamps():
    """The read at i + 1 keeps its term where i reaches the table's last
    selectable plane: the port equals numpy and the JAX package."""
    import halide_tpu as hl
    import halide_tpu_torch as ht
    got, vals = _fractional_slice(ht)
    want, _ = _fractional_slice(hl)
    ivn = np.clip(vals.astype(np.int32), 0, 3)
    wn = vals - vals.astype(np.int32)
    ref = (1 - wn) * (ivn * 10.0) + wn * ((ivn + 1) * 10.0)
    np.testing.assert_allclose(got, ref.astype(np.float32), rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)

"""The autoschedulers in the port (halide_tpu_torch.autoschedule), against
the JAX package.

The cases of tests/test_autoschedule.py, each in the port on the CPU; then
decision parity: with the same coefficients in both packages (the
HT_COST_* variables), Mullapudi2016's greedy and Adams2019's beam choose
the same materialization sets on those pipelines and on blur, unsharp,
harris and camera_pipe built by each package, and Li2018 writes the same
schedule; then realize parity: each app autoscheduled by each package
realizes to the same output (bit for bit for the integer apps, within the
app's tolerance for float ones). The port's tile (`_pick_tile`, the card's
terms) may differ from the JAX package's; its output may not."""
import re

import numpy as np
import pytest
import torch

import halide_tpu_torch as ht
from halide_tpu_torch import autoschedule as tas
from halide_tpu_torch.apps import get as torch_get
from halide_tpu_torch.ops import group_kernel as gk

SMALL = dict(width=96, height=64)       # tests/test_apps.py's sizes


def _jax():
    """The JAX package, imported by the tests that hold the port against it
    (the machine with the card has no JAX; the gpu tests import none)."""
    import halide_tpu
    import halide_tpu.apps
    import halide_tpu.autoschedule
    return halide_tpu


def _compare(app, got, want):
    from test_torch_apps import _compare as compare
    compare(app, got, want)


def _blur(m):
    x, y = m.Var("x"), m.Var("y")
    img = m.ImageParam(m.UInt(16), 2, "as_in")
    bx, by = m.Func("as_bx"), m.Func("as_by")
    bx[x, y] = (img[x, y] + img[x + 1, y] + img[x + 2, y]) / 3
    by[x, y] = (bx[x, y] + bx[x, y + 1] + bx[x, y + 2]) / 3
    by.set_estimates([(0, 254), (0, 126)])
    return m.Pipeline(by), img


def _pyramid(m):
    """2x downsample chain: the cost model must materialize between the
    separable strided stages."""
    x, y = m.Var("x"), m.Var("y")
    img = m.ImageParam(m.Float(32), 2, "pyr_in")
    dx, d1 = m.Func("pyr_dx"), m.Func("pyr_d1")
    dx[x, y] = (img[m.clamp(2 * x - 1, 0, 511), y]
                + 2.0 * img[m.clamp(2 * x, 0, 511), y]
                + img[m.clamp(2 * x + 1, 0, 511), y]) * 0.25
    d1[x, y] = (dx[x, m.clamp(2 * y - 1, 0, 255)]
                + 2.0 * dx[x, m.clamp(2 * y, 0, 255)]
                + dx[x, m.clamp(2 * y + 1, 0, 255)]) * 0.25
    d1.set_estimates([(0, 256), (0, 128)])
    return m.Pipeline(d1), img


def _li_small(m):
    x = m.Var("x")
    img = m.ImageParam(m.Float(32), 1, "li_in")
    sq = m.Func("li_sq")
    sq[x] = img[x] * img[x]
    r = m.RDom(0, 4096)
    loss = m.Func("li_loss")
    loss[x] = 0.0
    loss[x] += sq[r.x]
    loss.set_estimates([(0, 1)])
    return m.Pipeline(loss), img


def _li_large(m):
    x, y = m.Var("x"), m.Var("y")
    img = m.ImageParam(m.Float(32), 2, "li2_in")
    r = m.RDom(0, 16)
    acc = m.Func("li2_acc")
    acc[x, y] = 0.0
    acc[x, y] += img[x, m.clamp(y + r.x, 0, 127)]
    acc.set_estimates([(0, 512), (0, 128)])
    return m.Pipeline(acc), img


def _an3(m):
    x, y = m.Var("x"), m.Var("y")
    img = m.ImageParam(m.Float(32), 2, "an_in")
    a, b, out = m.Func("an_a"), m.Func("an_b"), m.Func("an_out")
    a[x, y] = img[x, y] * 2.0 + img[x + 1, y]
    b[x, y] = a[x, y] + a[x, y + 1]
    out[x, y] = b[x, y] * 0.5 + a[x, y]
    out.set_estimates([(0, 256), (0, 64)])
    return m.Pipeline(out), img


def _an_unbound(m):
    x, y = m.Var("x"), m.Var("y")
    img = m.ImageParam(m.Float(32), 2, "an2_in")
    f = m.Func("an2_f")
    f[x, y] = img[x, y] + 1.0
    f.set_estimates([(0, 128), (0, 32)])
    return m.Pipeline(f), img


# ---------------------------------------------------------------------------
# the cases of tests/test_autoschedule.py, in the port
# ---------------------------------------------------------------------------

def test_autoschedule_blur():
    p, img = _blur(ht)
    res = p.apply_autoscheduler()
    assert "tile" in res["schedule_source"]
    assert "as_bx.compute_at" in res["schedule_source"]
    rng = np.random.default_rng(0)
    data = rng.integers(0, 1 << 14, (128, 256), np.uint16)
    img.set(torch.from_numpy(data))
    launches = gk.launches
    gk.last_plan = None
    out = p.realize([254, 126], device="cpu").to_numpy()
    ref = (data[:, :-2].astype(np.uint16) + data[:, 1:-1] + data[:, 2:]) // 3
    ref = (ref[:-2] + ref[1:-1] + ref[2:]) // 3
    np.testing.assert_array_equal(out, ref)
    # the schedule it wrote is K1's: a plan, computed by the plain version
    # on the CPU (no launch)
    assert gk.last_plan["func"] == "as_by"
    assert gk.last_plan["members"] == ["as_bx"]
    assert gk.launches == launches


def test_greedy_materializes_strided_stage():
    p, img = _pyramid(ht)
    res = p.apply_autoscheduler()
    assert "pyr_dx.compute_root()" in res["schedule_source"], res
    rng = np.random.default_rng(1)
    data = rng.standard_normal((256, 512)).astype(np.float32)
    img.set(torch.from_numpy(data))
    out = p.realize([256, 128], device="cpu").to_numpy()
    dxr = (data[:, np.clip(2 * np.arange(256) - 1, 0, 511)]
           + 2 * data[:, np.clip(2 * np.arange(256), 0, 511)]
           + data[:, np.clip(2 * np.arange(256) + 1, 0, 511)]) \
        * np.float32(0.25)
    ref = (dxr[np.clip(2 * np.arange(128) - 1, 0, 255)]
           + 2 * dxr[np.clip(2 * np.arange(128), 0, 255)]
           + dxr[np.clip(2 * np.arange(128) + 1, 0, 255)]) \
        * np.float32(0.25)
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_beam_search_not_worse_than_greedy():
    p, _img = _pyramid(ht)
    an = tas._Analysis(p)
    assert tas._cost(an, tas._beam(an)) <= tas._cost(an, tas._greedy(an)) \
        + 1e-6


def test_li2018_schedules_gradient_style_pipeline():
    """Li2018 (reference: li2018/GradientAutoscheduler.cpp apply_schedule
    @573): compute_root + loop marks per func, and rfactor'd reduction
    parallelism for a small-pure-domain associative update."""
    p, img = _li_small(ht)
    src = p.apply_autoscheduler(params={"name": "Li2018"})["schedule_source"]
    assert "li_loss.compute_root()" in src, src
    assert "rfactor" in src and ".split(" in src, src
    data = np.arange(4096, dtype=np.float32) / 4096.0
    img.set(torch.from_numpy(data))
    out = p.realize([1], device="cpu").to_numpy()
    np.testing.assert_allclose(out, [(data * data).sum()], rtol=1e-4)


def test_li2018_large_pure_domain_no_rfactor():
    """A wide pure domain already parallelizes; Li2018 must not rfactor."""
    p, img = _li_large(ht)
    src = p.apply_autoscheduler(params={"name": "Li2018"})["schedule_source"]
    assert "rfactor" not in src, src
    assert "li2_acc.compute_root()" in src
    rng = np.random.default_rng(0)
    data = rng.standard_normal((128, 512)).astype(np.float32)
    img.set(torch.from_numpy(data))
    out = p.realize([512, 128], device="cpu").to_numpy()
    idx = np.clip(np.arange(128)[:, None] + np.arange(16)[None, :], 0, 127)
    ref = data[idx, :].sum(axis=1)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_anderson2021_autotunes_by_measurement():
    """Anderson2021: the beam's top-K candidates are timed on serialized
    clones (the wall clock on the CPU) and the measured winner is applied;
    the report carries the sample times."""
    p, img = _an3(ht)
    rng = np.random.default_rng(3)
    data = rng.random((66, 258), np.float32)
    img.set(torch.from_numpy(data))
    res = p.apply_autoscheduler(params={"name": "Anderson2021",
                                        "samples": 3, "benchmarks": 2,
                                        "device": "cpu"})
    assert "autotuned" in res, res
    tuned = res["autotuned"]
    assert tuned["samples"] >= 2 and tuned["device"] == "cpu"
    assert tuned["best_ms"] == min(tuned["times_ms"])
    got = p.realize([256, 64], device="cpu").to_numpy()
    a_full = data[:66, :257] * 2.0 + data[:66, 1:258]
    b_full = a_full[:65] + a_full[1:66]
    want = b_full[:64, :256] * 0.5 + a_full[:64, :256]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_anderson2021_unbound_inputs_degrades_to_model():
    """With nothing to time against (unbound inputs), Anderson2021 still
    produces a schedule -- model-ranked, no autotuned report."""
    p, _img = _an_unbound(ht)
    res = p.apply_autoscheduler(params={"name": "Anderson2021"})
    assert "schedule_source" in res
    assert "autotuned" not in res


def test_anderson2021_needs_the_card_unless_asked_for_the_cpu():
    """Bound inputs and no device: the tournament runs on the card, and
    raises where there is none (nothing carries on on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is attached")
    p, img = _an3(ht)
    img.set(torch.zeros((66, 258)))
    with pytest.raises(RuntimeError, match="CUDA"):
        p.apply_autoscheduler(params={"name": "Anderson2021",
                                      "samples": 2})


# ---------------------------------------------------------------------------
# decision parity with the JAX package, at the same coefficients
# ---------------------------------------------------------------------------

@pytest.fixture(params=[{}, {"HT_COST_OPS_PER_BYTE": "5.5",
                             "HT_COST_STRIDED_PENALTY": "8.7"}],
                ids=["card", "jax_v5e"])
def same_coeffs(request, monkeypatch):
    """Both packages read the same coefficients: the port's fitted row
    (`sm_90`, the measured card's), or the JAX package's v5e fit, each
    given to both through the HT_COST_* variables."""
    env = dict(request.param)
    if not env:
        row = ht.target.FITTED_COST["sm_90"]
        env = {"HT_COST_OPS_PER_BYTE": str(row["ops_per_byte"]),
               "HT_COST_STRIDED_PENALTY": str(row["strided_penalty"])}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(_jax().autoschedule, "_FITTED", None)
    monkeypatch.setattr(tas, "_FITTED", None)
    return env


_PIPES = {"blur": _blur, "pyramid": _pyramid, "li_small": _li_small,
          "li_large": _li_large, "an3": _an3, "an_unbound": _an_unbound}


def _unschedule(m, app):
    """Clear every producer's compute level and compute_with in place,
    in either package, so that the autoscheduler decides them all (the
    reference's apps build their auto-scheduled variant without the
    manual schedule)."""
    from importlib import import_module
    loop_level = import_module(m.__name__ + ".schedule").LoopLevel
    for f in m.pipeline.gather_graph(app.pipeline.outputs).funcs:
        if f not in app.pipeline.outputs:
            f._fschedule.compute_level = loop_level()
            for d in f._defs:
                d.schedule.fused_with = []


def _app(m, name, kw, free=False):
    """The app built by package m at `kw`, its output's estimates its
    sizes; with `free`, its producers unscheduled."""
    app = (torch_get if m is ht else m.apps.get)(name)(**kw)
    if free:
        _unschedule(m, app)
    for out in app.pipeline.outputs:
        out.set_estimates([(0, int(s)) for s in app.output_sizes])
    return app


def _app_pipeline(m, name):
    free = name.startswith("free:")
    name = name.split(":")[-1]
    kw = dict(out_width=128, out_height=96) if name == "camera_pipe" \
        else SMALL
    return _app(m, name, kw, free).pipeline


def _decisions(mod, p):
    an = mod._Analysis(p)
    names = (lambda s: sorted(an.by_id[i].name for i in s))
    return (names(mod._greedy(an)), names(mod._beam(an)),
            sorted(an.by_id[i].name for i in an.free), mod._cost(
                an, mod._greedy(an)))


@pytest.mark.parametrize("name", list(_PIPES) + [
    "app:blur", "app:unsharp", "app:harris", "app:camera_pipe",
    "free:unsharp", "free:harris"])
def test_same_materialization_as_jax(name, same_coeffs):
    hl = _jax()
    jas = hl.autoschedule
    if ":" in name:
        pj, pt = (_app_pipeline(m, name) for m in (hl, ht))
    else:
        pj, pt = _PIPES[name](hl)[0], _PIPES[name](ht)[0]
    gj, bj, fj, cj = _decisions(jas, pj)
    gt, bt, ft, ct = _decisions(tas, pt)
    assert ft == fj
    assert gt == gj and bt == bj
    assert ct == pytest.approx(cj, rel=1e-12)


@pytest.mark.parametrize("build", [_li_small, _li_large, _blur, _pyramid])
def test_li2018_writes_the_same_schedule_as_jax(build):
    """The same text, once an unnamed RDom's generated name (a counter of
    each package's process) is numbered alike."""
    hl = _jax()
    src = [re.sub(r"\br\d+\$", "r$", build(m)[0].apply_autoscheduler(
        params={"name": "Li2018"})["schedule_source"]) for m in (hl, ht)]
    assert src[1] == src[0]


@pytest.mark.parametrize("sched", ["Mullapudi2016", "Adams2019"])
@pytest.mark.parametrize("name,kw,free", [
    ("blur", SMALL, False), ("unsharp", SMALL, False),
    ("harris", SMALL, False),
    ("camera_pipe", dict(out_width=128, out_height=96), False),
    ("unsharp", SMALL, True), ("harris", SMALL, True)])
def test_autoscheduled_app_realizes_as_jax(name, kw, free, sched,
                                           same_coeffs):
    """Each package autoschedules its own build of the app (with `free`,
    its producers unscheduled); the outputs agree under the app's rule,
    and the port's equals the golden."""
    hl = _jax()
    outs = []
    for m in (hl, ht):
        app = _app(m, name, kw, free)
        app.pipeline.apply_autoscheduler(params={"name": sched})
        data = app.make_inputs(0)
        if m is ht:
            app.bind(data, "cpu")
            outs.append(app.realize("cpu").to_numpy())
        else:
            app.bind(data)
            outs.append(np.asarray(app.realize().to_numpy()))
    _compare(app, outs[1], outs[0])
    _compare(app, outs[1], app.reference(**data))


def test_pick_tile_terms():
    """The card's tile: K1's largest sub-tile clipped to the extent, which
    leaves K1's planner every sub-tile (it weighs halo, shared memory and
    the SMs' fill itself); a forced tile is written as given."""
    assert tas._pick_tile(2560, 1536) == (256, 128)
    assert tas._pick_tile(254, 126) == (254, 126)
    assert tas._pick_tile(100, 1536) == (100, 128)
    for tile, want in ((None, "256, 128"), ((128, 64), "128, 64")):
        p, _f = _blur(ht)
        p.outputs[0].set_estimates([(0, 2558), (0, 1534)])
        src = p.apply_autoscheduler(
            params={} if tile is None else {"tile": tile})["schedule_source"]
        assert f"xi, yi, {want})" in src, src


@pytest.mark.gpu
@pytest.mark.parametrize("sched", ["Mullapudi2016", "Adams2019"])
def test_autoscheduled_blur_on_the_card(sched):
    """The schedule the autoscheduler writes runs through K1 on the card,
    bit for bit the CPU's plain version and the golden."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    app = torch_get("blur")(width=2560, height=1536)
    app.pipeline.outputs[0].set_estimates([(0, 2558), (0, 1534)])
    app.pipeline.apply_autoscheduler(params={"name": sched})
    data = app.make_inputs(0)
    app.bind(data)
    launches = gk.launches
    got = app.realize().to_numpy()
    assert gk.launches == launches + 1
    np.testing.assert_array_equal(got, app.reference(**data))


@pytest.mark.parametrize("name,kw,free", [
    ("unsharp", SMALL, True), ("harris", SMALL, True),
    ("camera_pipe", dict(out_width=128, out_height=96,
                         roots="deinterleaved,g_r,g_b"), False)])
def test_unscheduled_app_is_one_group(name, kw, free):
    """With its producers unscheduled (camera_pipe keeping its demosaic's
    roots), each app's autoscheduled schedule is one K1 group that the
    planner takes (no reject): every producer the group can hold is
    staged, and one read at x / 2 (camera_pipe's half-resolution stages)
    is left out, which K1 takes as a window and not as a member."""
    app = _app(ht, name, kw, free)
    src = app.pipeline.apply_autoscheduler()["schedule_source"]
    data = app.make_inputs(0)
    app.bind(data, "cpu")
    rejects = sum(gk.rejects.values())
    gk.last_plan = None
    got = app.realize("cpu").to_numpy()
    assert sum(gk.rejects.values()) == rejects
    assert gk.last_plan["func"] == app.pipeline.outputs[0].name
    assert len(gk.last_plan["members"]) == src.count(".compute_at(")
    _compare(app, got, app.reference(**data))

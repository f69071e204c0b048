"""The apps of the port against the JAX package's apps and their numpy
goldens, on the CPU at the small sizes of tests/test_apps.py, with its
comparison rules: bit for bit where the app's tolerance is 0 (blur, u16),
else within the app's rtol/atol (linear_blur: 1e-4, which covers the two
libms' pow and XLA's fused multiply-adds; iir_blur: 2e-3; hist: atol 2, for
the float Y that may fall into a neighbouring bin where it lies within an
ulp of an integer)."""
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
    jkw = {k: v for k, v in kw.items() if k != "tile"}
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

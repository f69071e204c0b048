"""The row-histogram kernel (halide_tpu_torch/ops/rowhist_kernel.py, K3) on
the CPU: its plain version against the JAX package's `rowhist_blockdiag`
(Pallas, interpret mode) at the shapes of tests/test_reductions.py (R and P
not block multiples, out-of-range bins that drop, K not a power of two); the
CUDA source built with the host C++ compiler against the plain version; the
update path's dispatch to K3; and the wrappers' routes. The kernel itself
runs only on the card (the test marked gpu). Counts are integers below 2^24
in f32: every comparison is exact."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import halide_tpu_torch as thl
from halide_tpu_torch.ops import build, rowhist_kernel

SHAPES = [(7, 130, 100), (64, 513, 256), (300, 128, 64)]


def _lin(R, P, K, seed=2):
    return np.random.default_rng(seed).integers(-2, K + 3, (R, P)).astype(
        np.int32)


@pytest.mark.parametrize("R,P,K", SHAPES)
def test_plain_version_matches_jax_rowhist(R, P, K):
    import jax.numpy as jnp
    from halide_tpu.ops import onehot_mxu
    lin = _lin(R, P, K)
    want = np.asarray(onehot_mxu.rowhist_blockdiag(jnp.asarray(lin), K,
                                                   interpret=True))
    got = rowhist_kernel.rowhist_plain(torch.from_numpy(lin), K).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        rowhist_kernel.rowhist_plain(torch.from_numpy(lin), K, 3.0).numpy(),
        want * 3)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("R,P,K", SHAPES)
def test_kernel_source_on_host_matches_plain_version(R, P, K, transposed,
                                                     tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel source")
    so = tmp_path / "rowhist_kernel.so"
    r = subprocess.run(
        [gxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
         str(so), str(build.CSRC / "rowhist_kernel.cu")],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    lib = rowhist_kernel.bind(ctypes.CDLL(str(so)))
    lin = torch.from_numpy(_lin(R, P, K, seed=3))
    if transposed:          # neighbouring rows adjacent: rows_fast
        lin = lin.t().contiguous().t()
    out = torch.empty((R, K), dtype=torch.float32)
    assert rowhist_kernel.call(lib, lin, K, 2.0, out) == 0
    np.testing.assert_array_equal(
        out.numpy(), rowhist_kernel.rowhist_plain(lin, K, 2.0).numpy())


def _hist_rows(hl, rows, width, seed=1):
    x, y = hl.Var("x"), hl.Var("y")
    data = np.random.default_rng(seed).integers(0, 256, (rows, width),
                                                np.uint8)
    inp = hl.Buffer(data)
    hr = hl.Func("hist_rows_k3")
    hr[x, y] = 0
    rx = hl.RDom(0, width, "rx")
    hr[hl.i32(inp[rx.x, y]), y] += 1
    want = np.stack([np.bincount(r, minlength=256) for r in data])
    return hr, want


def test_row_histogram_update_takes_the_kernel_route(monkeypatch):
    """A constant-value row histogram (apps/hist's hist_rows) reaches K3's
    wrapper with the (rows, pixels) bins, as the JAX package's opt-in
    branch reaches rowhist_blockdiag (tests/test_reductions.py:411)."""
    seen = {}
    orig = rowhist_kernel.rowhist

    def spy(lin2d, K, scale=1.0):
        seen.update(K=K, shape=tuple(lin2d.shape), scale=scale)
        return orig(lin2d, K, scale)

    monkeypatch.setattr(rowhist_kernel, "rowhist", spy)
    launches = rowhist_kernel.launches
    hr, want = _hist_rows(thl, 300, 640)
    out = hr.realize([256, 300], device="cpu").to_numpy()
    np.testing.assert_array_equal(out, want)
    assert seen == dict(K=256, shape=(300, 640), scale=1.0), seen
    assert rowhist_kernel.launches == launches      # CPU: plain version


def test_small_row_histogram_takes_the_native_scatter(monkeypatch):
    """Below K3's gate (fewer than 128 reduced points) the same update is
    an exact integer scatter."""
    called = []
    monkeypatch.setattr(rowhist_kernel, "rowhist",
                        lambda *a, **k: called.append(a))
    hr, want = _hist_rows(thl, 300, 96)
    np.testing.assert_array_equal(
        hr.realize([256, 300], device="cpu").to_numpy(), want)
    assert not called


@pytest.mark.parametrize("weight,k3", [(2.5, True), (0.1, False)])
def test_float_weight_row_histogram_matches_jax(weight, k3, monkeypatch):
    """A float constant weight exact in bf16 takes K3 with that scale; one
    that is not (0.1) takes the native scatter. Both against the JAX
    package (tests/test_reductions.py's float-weight histogram)."""
    import halide_tpu as jhl
    scales = []
    orig = rowhist_kernel.rowhist

    def spy(lin2d, K, scale=1.0):
        scales.append(scale)
        return orig(lin2d, K, scale)

    monkeypatch.setattr(rowhist_kernel, "rowhist", spy)

    def build(hl):
        x, y = hl.Var("x"), hl.Var("y")
        data = np.random.default_rng(2).integers(0, 128, (300, 640),
                                                 np.uint8)
        hr = hl.Func(f"hist_fw_{weight}")
        hr[x, y] = hl.f32(0)
        rx = hl.RDom(0, 640, "rx")
        hr[hl.i32(hl.Buffer(data)[rx.x, y]), y] += weight
        return hr, data

    hr, data = build(thl)
    got = hr.realize([128, 300], device="cpu").to_numpy()
    assert scales == ([weight] if k3 else [])
    jhr, _ = build(jhl)
    want = np.asarray(jhr.realize([128, 300]).to_numpy())
    golden = np.stack([np.bincount(r, minlength=128) for r in data]) \
        .astype(np.float64) * weight
    if k3:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, golden.astype(np.float32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(got, golden, rtol=1e-5)


def test_launch_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="not on the card"):
        rowhist_kernel.launch(torch.zeros((4, 8), dtype=torch.int32), 16)


@pytest.mark.gpu
@pytest.mark.parametrize("R,P,K,transposed", [
    (2560, 1536, 256, True), (2560, 1536, 256, False),
    (7, 130, 100, False), (300, 128, 64, True)])
def test_kernel_matches_plain_version_on_the_card(R, P, K, transposed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lin = torch.from_numpy(_lin(R, P, K, seed=4)).cuda()
    if transposed:
        lin = lin.t().contiguous().t()
    before = rowhist_kernel.launches
    got = rowhist_kernel.rowhist(lin, K, 1.0)
    assert rowhist_kernel.launches == before + 1
    want = rowhist_kernel.rowhist_plain(lin, K, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)

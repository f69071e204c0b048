"""The scan kernel (halide_tpu_torch/ops/scan_kernel.py, K2) on the CPU: its
plain version against the JAX package's `linear_scan` (Pallas, interpret
mode), both bodies (K2a, a constant coefficient; K2b, a per-element one),
forward and backward, with the scan axis first, in the middle and last and
N not a multiple of the 256-block; the CUDA source built with the host C++
compiler against the plain version; and the wrappers' routes. The kernel
itself runs only on the card (the tests marked gpu).

Tolerance rtol 1e-4 / atol 1e-5 against the JAX kernel and against a float64
recurrence, as tests/test_pallas_scan.py uses: the plain version rounds in
the JAX kernel's order (Kogge-Stone rounds), the CUDA source sequentially.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from halide_tpu_torch.apps import get as torch_get
from halide_tpu_torch.ops import build, scan_kernel

# (shape, scan axis): the axis first, in the middle and last; N is not a
# multiple of the 256-block (and crosses it)
SHAPES = [((300, 3, 20), 0), ((2, 37, 130), 1), ((1, 557, 24), 1),
          ((3, 4, 300), 2)]


def _inputs(shape, axis, seed):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(shape).astype(np.float32)
    a = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    ishape = list(shape)
    ishape[axis] = 1
    init = rng.standard_normal(ishape).astype(np.float32)
    return a, b, init


def _golden(a, b, init, axis, backward):
    """float64 recurrence y[i] = a[i]*y[i-1] + b[i] along `axis`."""
    a, b = np.moveaxis(a, axis, 0), np.moveaxis(b, axis, 0)
    prev = np.moveaxis(init, axis, 0)[0].astype(np.float64)
    y = np.zeros(b.shape, np.float64)
    order = range(b.shape[0] - 1, -1, -1) if backward else range(b.shape[0])
    for i in order:
        prev = a[i].astype(np.float64) * prev + b[i]
        y[i] = prev
    return np.moveaxis(y, 0, axis)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape,axis", SHAPES)
@pytest.mark.parametrize("body", ["const", "general"])
def test_plain_version_matches_jax_linear_scan(body, shape, axis, backward):
    import jax.numpy as jnp
    from halide_tpu.ops import pallas_scan as ps
    a, b, init = _inputs(shape, axis, 0)
    if body == "const":
        a = np.full(shape, 0.9, np.float32)
        kw_j, kw_t = dict(a_const=0.9), dict(a_const=0.9)
    else:
        kw_j, kw_t = dict(a=jnp.asarray(a)), dict(a=torch.from_numpy(a))
    want = np.asarray(ps.linear_scan(jnp.asarray(b), jnp.asarray(init), axis,
                                     backward, interpret=True, **kw_j))
    got = scan_kernel.linear_scan_plain(
        torch.from_numpy(b), torch.from_numpy(init), axis, backward,
        **kw_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, _golden(a, b, init, axis, backward),
                               rtol=1e-4, atol=1e-5)


def _host_build(tmp_path, name):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel source")
    so = tmp_path / f"{name}.so"
    r = subprocess.run(
        [gxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
         "-ffp-contract=off", "-o", str(so), str(build.CSRC / f"{name}.cu")],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(so))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("body", ["const", "general"])
def test_kernel_source_on_host_matches_plain_version(body, backward,
                                                     tmp_path):
    """The CUDA source's line body, built for the host, through the same
    strides the wrapper passes: a span of a larger tensor as `out` (the
    Func's buffer), a transposed view as `b`."""
    lib = scan_kernel.bind(_host_build(tmp_path, "scan_kernel"))
    rng = np.random.default_rng(1)
    full = torch.from_numpy(rng.standard_normal((3, 300, 40)).astype(
        np.float32))
    axis = 1
    out = full.narrow(axis, 5, 290)
    init = full.narrow(axis, 295 if backward else 4, 1).clone()
    b = torch.from_numpy(rng.standard_normal((3, 40, 290)).astype(
        np.float32)).transpose(1, 2)
    kw = dict(a_const=0.8) if body == "const" else \
        dict(a=torch.from_numpy(rng.uniform(-0.9, 0.9, (3, 290, 40))
                                .astype(np.float32)))
    want = scan_kernel.linear_scan_plain(b, init, axis, backward, **kw)
    before = full.clone()
    assert scan_kernel.call(lib, out, b, init, axis, backward, **kw) == 0
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    outside = torch.ones(300, dtype=torch.bool)
    outside[5:295] = False
    assert torch.equal(full[:, outside], before[:, outside])


def test_cpu_tensors_take_the_plain_version_and_launch_refuses_them():
    before = dict(scan_kernel.launches)
    app = torch_get("iir_blur")(width=96, height=64)
    data = app.make_inputs(0)
    app.bind(data, "cpu")
    got = app.realize("cpu").to_numpy()
    assert scan_kernel.launches == before
    np.testing.assert_allclose(got, app.reference(**data), rtol=2e-3,
                               atol=2e-3)
    t = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="not on the card"):
        scan_kernel.launch(t, t, t[:1], 0, False, a_const=0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape,axis", SHAPES + [((3, 2559, 1536), 1),
                                                 ((3, 2560, 1535), 2)])
@pytest.mark.parametrize("body", ["const", "general"])
def test_kernel_matches_plain_version_on_the_card(body, shape, axis,
                                                  backward):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b, init = _inputs(shape, axis, 2)
    b = torch.from_numpy(np.abs(b) % 1.0).cuda()      # data in [0, 1)
    init = torch.from_numpy(np.abs(init) % 1.0).cuda()
    kw = dict(a_const=0.9) if body == "const" else \
        dict(a=torch.from_numpy(np.clip(a, -0.95, 0.95)).cuda())
    out = torch.empty_like(b)
    before = scan_kernel.launches[body]
    scan_kernel.linear_scan(out, b, init, axis, backward, **kw)
    assert scan_kernel.launches[body] == before + 1
    plain = scan_kernel.linear_scan_plain(b, init, axis, backward, **kw)
    torch.cuda.synchronize()
    assert (out - plain).abs().max().item() <= 1e-5

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


# The segmented source (32 lines by 128-element segments, look-back between
# segments): (shape, scan axis, offset) with N not a multiple of the
# segment; M == 1 (the contiguous axis, staged through shared memory, by
# 16-byte loads at offset 0 and by element at offset 1, where the base is
# not 16-byte aligned) and M > 1 (lanes along m); lines not a multiple of
# 32; the last two with few line tiles and several segments, so that the
# host build's waves of blocks look back over several published pairs
# before an inclusive value
SEG_SHAPES = [((5, 37, 300), 2, 0), ((5, 37, 300), 2, 1), ((300, 70), 0, 0),
              ((3, 261, 40), 1, 1), ((40, 700), 1, 0), ((700, 20), 0, 1)]
# coefficients: a = 1 (a running sum), a constant 0.9, a per-element a with
# zeros (the predicated case: the recurrence restarts), a per-element a
SEG_COEFS = ["one", "const", "zeros", "general"]


def _seg_inputs(shape, axis, coef, seed=4):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(shape).astype(np.float32)
    ishape = list(shape)
    ishape[axis] = 1
    init = rng.standard_normal(ishape).astype(np.float32)
    a = rng.uniform(-0.95, 0.95, shape).astype(np.float32)
    if coef == "zeros":
        a[rng.random(shape) < 0.3] = 0.0
    kw = {"one": dict(a_const=1.0), "const": dict(a_const=0.9)}.get(coef)
    return a, b, init, kw


def _offset(t, offset):
    """t's values in a tensor whose data starts `offset` elements into a
    16-byte-aligned buffer."""
    buf = torch.zeros(t.numel() + 8, dtype=t.dtype)
    v = buf[offset:offset + t.numel()].view(t.shape)
    v.copy_(t)
    return v


@pytest.fixture(scope="module")
def scan_host_lib(tmp_path_factory):
    """The g++ build of csrc/scan_kernel.cu, once for the module."""
    return scan_kernel.bind(_host_build(tmp_path_factory.mktemp("scan"),
                                        "scan_kernel"))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("coef", SEG_COEFS)
@pytest.mark.parametrize("shape,axis,offset", SEG_SHAPES)
def test_segmented_source_on_host_matches_plain_and_jax(shape, axis, offset,
                                                        coef, backward,
                                                        scan_host_lib):
    """The g++ build runs the card's blocks in ticket order with the same
    segment arithmetic and look-back: equal to the plain version and to the
    JAX package's linear_scan (Pallas in interpret mode) within rtol 1e-4 /
    atol 1e-5."""
    import jax.numpy as jnp
    from halide_tpu.ops import pallas_scan as ps
    lib = scan_host_lib
    a, b, init, kw = _seg_inputs(shape, axis, coef)
    bt = _offset(torch.from_numpy(b), offset)
    it = torch.from_numpy(init)
    if kw is None:
        kw_t = dict(a=_offset(torch.from_numpy(a), offset))
        kw_j = dict(a=jnp.asarray(a))
    else:
        kw_t, kw_j = kw, kw
    out = _offset(torch.zeros(shape), offset)
    assert scan_kernel.call(lib, out, bt, it, axis, backward, **kw_t) == 0
    want = scan_kernel.linear_scan_plain(bt, it, axis, backward, **kw_t)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    ref = np.asarray(ps.linear_scan(jnp.asarray(b), jnp.asarray(init), axis,
                                    backward, interpret=True, **kw_j))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sub", [16, 32])
@pytest.mark.parametrize("shape,axis,offset", [SEG_SHAPES[1], SEG_SHAPES[4],
                                               SEG_SHAPES[5]])
def test_segment_lengths_on_host(shape, axis, offset, sub, scan_host_lib):
    """K2a at 16 and 32 elements a thread (segments of 128 and 256) equals
    the plain version; K2b takes 16 only, and refuses 32 with a code."""
    a, b, init, _kw = _seg_inputs(shape, axis, "const")
    bt = _offset(torch.from_numpy(b), offset)
    it = torch.from_numpy(init)
    for backward in (False, True):
        out = _offset(torch.zeros(shape), offset)
        assert scan_kernel.call(scan_host_lib, out, bt, it, axis, backward,
                                a_const=0.9, sub=sub) == 0
        want = scan_kernel.linear_scan_plain(bt, it, axis, backward,
                                             a_const=0.9)
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)
    rc = scan_kernel.call(scan_host_lib, torch.zeros(shape), bt, it, axis,
                          False, a=torch.from_numpy(a), sub=sub)
    assert (rc == 0) == (sub == 16)


@pytest.mark.gpu
@pytest.mark.parametrize("sub", [16, 32])
def test_segment_lengths_on_the_card(sub):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for shape, axis, offset in SEG_SHAPES:
        _a, b, init, _kw = _seg_inputs(shape, axis, "const")
        bt = torch.empty(b.size + 8, device="cuda")[offset:offset + b.size] \
            .view(shape).copy_(torch.from_numpy(b))
        it = torch.from_numpy(init).cuda()
        for backward in (False, True):
            out = torch.empty_like(bt)
            scan_kernel.launch(out, bt, it, axis, backward, a_const=0.9,
                               sub=sub)
            plain = scan_kernel.linear_scan_plain(bt, it, axis, backward,
                                                  a_const=0.9)
            torch.cuda.synchronize()
            np.testing.assert_allclose(out.cpu().numpy(),
                                       plain.cpu().numpy(), rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("coef", SEG_COEFS)
@pytest.mark.parametrize("shape,axis,offset", SEG_SHAPES)
def test_segmented_kernel_matches_plain_version_on_the_card(shape, axis,
                                                            offset, coef,
                                                            backward):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b, init, kw = _seg_inputs(shape, axis, coef)
    bt = torch.empty(b.size + 8, device="cuda")[offset:offset + b.size] \
        .view(shape).copy_(torch.from_numpy(b))
    it = torch.from_numpy(init).cuda()
    kw_t = kw if kw is not None else dict(a=torch.from_numpy(a).cuda())
    out = torch.empty(b.size + 8, device="cuda")[offset:offset + b.size] \
        .view(shape)
    body = "const" if kw is not None else "general"
    before = scan_kernel.launches[body]
    scan_kernel.linear_scan(out, bt, it, axis, backward, **kw_t)
    assert scan_kernel.launches[body] == before + 1
    plain = scan_kernel.linear_scan_plain(bt, it, axis, backward, **kw_t)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), plain.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)

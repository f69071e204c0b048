"""propagate_adjoints in the port (halide_tpu_torch.derivative), against the
JAX package's.

The cases of tests/test_autodiff.py in the port on the CPU; then gradient
parity with JAX's propagate_adjoints (rtol 1e-5, atol 1e-6) on those four
pipelines, on gaussian_blur's untiled pipeline, and through the kernels:
the JAX package differentiates through its Pallas kernels (a tiled group,
a scan), so the port differentiates through each of its own: K1 by
`group_kernel._GroupGrad` (the kernel forward, its plain version's
vector-Jacobian product backward: plain torch ops over the kernel's own
recomputation, as no JAX kernel has a backward kernel either) and the
scans K2a/K2b by `scan_kernel._ScanGrad` (a scan in the other direction,
through the same wrapper). Each such path is checked to go through its
Function, so that no gradient leaves a kernel's share out."""
import numpy as np
import pytest
import torch

import halide_tpu_torch as ht
from halide_tpu_torch.ops import group_kernel as gk
from halide_tpu_torch.ops import scan_kernel as sk

RTOL, ATOL = 1e-5, 1e-6


def _jax():
    """The JAX package, imported by the tests that hold the port against it
    (the machine with the card has no JAX; the gpu tests import none)."""
    import halide_tpu
    import halide_tpu.apps
    return halide_tpu


def _set(m, img, a):
    img.set(torch.from_numpy(a) if m is ht else a)


def _grads(m, out, **kw):
    if m is ht:
        kw["device"] = "cpu"
    return m.propagate_adjoints(out, **kw)


# ---------------------------------------------------------------------------
# the cases of tests/test_autodiff.py, in the port
# ---------------------------------------------------------------------------

def _pointwise(m):
    x = m.Var("x")
    img = m.ImageParam(m.Float(32), 1, "gimg")
    f = m.Func("gsq")
    f[x] = img[x] * img[x] + 3.0 * img[x]
    _set(m, img, np.arange(5, dtype=np.float32))
    return f, dict(sizes=[5])


def _stencil(m):
    x = m.Var("x")
    img = m.ImageParam(m.Float(32), 1, "simg")
    cl = m.repeat_edge(img)
    f = m.Func("gst")
    f[x] = cl[x - 1] + 2.0 * cl[x] + cl[x + 1]
    _set(m, img, np.arange(6, dtype=np.float32))
    return f, dict(sizes=[6], adjoint=np.ones(6, np.float32))


def _reduction(m):
    x = m.Var("x")
    img = m.ImageParam(m.Float(32), 1, "rimg")
    r = m.RDom(0, 4, "rg")
    f = m.Func("gred")
    f[x] = 0.0
    f[x] += img[x + r.x] * img[x + r.x]
    _set(m, img, np.arange(8, dtype=np.float32))
    return f, dict(sizes=[4])


def _scalar_param(m):
    x = m.Var("x")
    img = m.ImageParam(m.Float(32), 1, "pimg")
    gain = m.Param(m.Float(32), "gain")
    bias = m.Param(m.Float(32), "bias")
    f = m.Func("gp")
    f[x] = gain * img[x] * img[x] + bias
    _set(m, img, np.arange(4, dtype=np.float32))
    gain.set(2.5)
    bias.set(0.5)
    return f, dict(sizes=[4], wrt=[gain, bias, img])


def test_gradient_pointwise():
    f, kw = _pointwise(ht)
    data = np.arange(5, dtype=np.float32)
    grads = _grads(ht, f, **kw)
    np.testing.assert_allclose(grads["gimg"], 2 * data + 3, rtol=1e-6)


def test_gradient_stencil_with_adjoint():
    f, kw = _stencil(ht)
    grads = _grads(ht, f, **kw)
    img = next(t for t in ht.pipeline.gather_graph([f]).inputs.values())
    data = np.arange(6, dtype=np.float32)
    eps = 1e-2

    def val(d):
        img.set(torch.from_numpy(d.astype(np.float32)))
        return ht.Pipeline(f).realize([6], device="cpu").to_numpy().sum()
    base = val(data)
    fd = np.zeros(6, np.float32)
    for i in range(6):
        d2 = data.copy()
        d2[i] += eps
        fd[i] = (val(d2) - base) / eps
    np.testing.assert_allclose(grads["simg"], fd, rtol=1e-2, atol=1e-2)


def test_gradient_through_reduction():
    f, kw = _reduction(ht)
    data = np.arange(8, dtype=np.float32)
    grads = _grads(ht, f, **kw)
    count = np.zeros(8, np.float32)
    for xx in range(4):
        for rr in range(4):
            count[xx + rr] += 1
    np.testing.assert_allclose(grads["rimg"], 2 * data * count, rtol=1e-5)


def test_gradient_scalar_param():
    # reference: src/Derivative.h:52-71 -- adjoints w.r.t. scalar params
    f, kw = _scalar_param(ht)
    data = np.arange(4, dtype=np.float32)
    grads = _grads(ht, f, **kw)
    np.testing.assert_allclose(grads["gain"], np.sum(data * data), rtol=1e-6)
    np.testing.assert_allclose(grads["bias"], 4.0, rtol=1e-6)
    np.testing.assert_allclose(grads["pimg"], 2.5 * 2 * data, rtol=1e-6)


# ---------------------------------------------------------------------------
# gradient parity with the JAX package
# ---------------------------------------------------------------------------

def _tiled(m, tile=(32, 16), param=False):
    """A float stencil over a 2-D input, tiled with its producer computed
    at the tiles (K1 in the port, the Pallas group kernel in the JAX
    package), optionally scaled by a Param."""
    x, y = m.Var("x"), m.Var("y")
    img = m.ImageParam(m.Float(32), 2, "tin")
    cl = m.repeat_edge(img)
    bx, by = m.Func("tbx"), m.Func("tby")
    bx[x, y] = cl[x - 1, y] + 2.0 * cl[x, y] + cl[x + 1, y]
    val = bx[x, y - 1] + bx[x, y] * bx[x, y] + bx[x, y + 1]
    wrt = None
    if param:
        k = m.Param(m.Float(32), "k", 0.75)
        val = val * k
        wrt = [img, k]
    by[x, y] = val
    if tile is not None:
        xo, yo, xi, yi = (m.Var(n) for n in ("xo", "yo", "xi", "yi"))
        by.tile(x, y, xo, yo, xi, yi, *tile)
        bx.compute_at(by, xo)
    a = np.random.default_rng(0).random((48, 64), np.float32)
    _set(m, img, a)
    kw = dict(sizes=[64, 48])
    if wrt:
        kw["wrt"] = wrt
    return by, kw


def _check(gj, gt):
    assert sorted(gj) == sorted(gt)
    for k in gj:
        np.testing.assert_allclose(gt[k], np.asarray(gj[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("build", [_pointwise, _stencil, _reduction,
                                   _scalar_param])
def test_gradients_match_jax(build):
    hl = _jax()
    fj, kw = build(hl)
    ft, kw_t = build(ht)
    _check(_grads(hl, fj, **kw), _grads(ht, ft, **kw_t))


def test_gaussian_blur_untiled_matches_jax():
    hl = _jax()
    jax_get = hl.apps.get
    from halide_tpu_torch.apps import get as torch_get
    kw = dict(width=96, height=64)
    japp, tapp = jax_get("gaussian_blur")(**kw), torch_get("gaussian_blur")(
        **kw)
    data = japp.make_inputs(0)
    japp.bind(data)
    tapp.bind(data, "cpu")
    _check(hl.propagate_adjoints(japp.pipeline, sizes=japp.output_sizes),
           ht.propagate_adjoints(tapp.pipeline, sizes=tapp.output_sizes,
                                 device="cpu"))


class _Spy:
    """Counts the calls of a torch.autograd.Function's apply."""

    def __init__(self, monkeypatch, fn):
        self.n = 0
        orig = fn.apply

        def apply(*a):
            self.n += 1
            return orig(*a)
        monkeypatch.setattr(fn, "apply", apply)


@pytest.mark.parametrize("param", [False, True])
def test_tiled_group_gradient_goes_through_k1(param, monkeypatch):
    """The JAX package differentiates through its tiled group; the port
    goes through _GroupGrad (K1's plan, the plain version on the CPU) and
    gives the JAX gradient, the Param's adjoint included."""
    hl = _jax()
    spy = _Spy(monkeypatch, gk._GroupGrad)
    fj, kw = _tiled(hl, param=param)
    ft, kw_t = _tiled(ht, param=param)
    gt = _grads(ht, ft, **kw_t)
    assert spy.n == 1 and gk.last_plan["func"] == "tby"
    _check(_grads(hl, fj, **kw), gt)
    # the same gradient as the untiled pipeline's
    fu, kw_u = _tiled(ht, tile=None, param=param)
    _check(_grads(ht, fu, **kw_u), gt)


def test_scan_gradient_goes_through_the_scan(monkeypatch):
    """iir_blur's four constant-coefficient scans (K2a): _ScanGrad forward
    and a scan in the other direction backward, against JAX's gradient
    through its Pallas scan."""
    hl = _jax()
    jax_get = hl.apps.get
    from halide_tpu_torch.apps import get as torch_get
    spy = _Spy(monkeypatch, sk._ScanGrad)
    kw = dict(width=96, height=64)
    japp, tapp = jax_get("iir_blur")(**kw), torch_get("iir_blur")(**kw)
    data = japp.make_inputs(0)
    japp.bind(data)
    tapp.bind(data, "cpu")
    gt = ht.propagate_adjoints(tapp.pipeline, sizes=tapp.output_sizes,
                               device="cpu")
    assert spy.n == 4
    gj = hl.propagate_adjoints(japp.pipeline, sizes=japp.output_sizes)
    for k in gj:       # sums over 2,000-element columns: f32 rounding
        np.testing.assert_allclose(gt[k], gj[k], rtol=RTOL,
                                   atol=1e-5 * np.abs(gj[k]).max())


def _predicated(m, a):
    """out[x, y] = where(x odd) 0.5 out[x-1, y] + in[x, y]: a predicated
    recurrence, the general (per-element coefficient) scan K2b."""
    x, y = m.Var("x"), m.Var("y")
    img = m.ImageParam(m.Float(32), 2, "pin")
    r = m.RDom(1, a.shape[1] - 1, "pr")
    f = m.Func("pf")
    f[x, y] = img[x, y]
    r.where(r.x % 2 == 1)
    f[r.x, y] = 0.5 * f[r.x - 1, y] + img[r.x, y]
    _set(m, img, a)
    return f, dict(sizes=[a.shape[1], a.shape[0]])


def test_predicated_scan_gradient_matches_jax(monkeypatch):
    hl = _jax()
    spy = _Spy(monkeypatch, sk._ScanGrad)
    launches = dict(sk.launches)
    a = np.random.default_rng(1).random((8, 40), np.float32)
    fj, kw = _predicated(hl, a)
    ft, kw_t = _predicated(ht, a)
    gt = _grads(ht, ft, **kw_t)
    assert spy.n == 1 and sk.launches == launches
    _check(_grads(hl, fj, **kw), gt)


def test_scan_adjoint_against_autograd_of_the_plain_version():
    """_ScanGrad's backward (a scan the other way, with the coefficients
    moved by one) against torch autograd through the plain version, in
    both directions, with a constant and a per-element coefficient and a
    broadcast init."""
    rng = np.random.default_rng(2)
    for backward in (False, True):
        for const in (True, False):
            b = torch.tensor(rng.random((3, 33, 5), np.float32),
                             requires_grad=True)
            init = torch.tensor(rng.random((1, 1, 5), np.float32),
                                requires_grad=True)
            a = None if const else torch.tensor(
                rng.random((3, 33, 5), np.float32) * 0.9, requires_grad=True)
            g = torch.tensor(rng.random((3, 33, 5), np.float32))
            leaves = [b, init] + ([] if const else [a])
            y0 = sk.linear_scan_plain(b, init, 1, backward,
                                      0.7 if const else None, a)
            want = torch.autograd.grad(y0, leaves, g)
            y1 = sk._ScanGrad.apply(b, init, a, 1, backward,
                                    0.7 if const else None)
            got = torch.autograd.grad(y1, leaves, g)
            for w, h in zip(want, got):
                np.testing.assert_allclose(h.numpy(), w.numpy(), rtol=1e-5,
                                           atol=1e-6)


def test_integer_output_gives_zero_gradients():
    """An output that depends on the float input only through integers
    carries no gradient: zeros, as jax.grad gives."""
    x = ht.Var("x")
    img = ht.ImageParam(ht.Float(32), 1, "zin")
    f = ht.Func("zf")
    f[x] = ht.cast(ht.Int(32), img[x] * 4.0)
    img.set(torch.arange(6, dtype=torch.float32))
    g = ht.propagate_adjoints(f, sizes=[6], device="cpu")
    np.testing.assert_array_equal(g["zin"], np.zeros(6, np.float32))


def test_propagate_adjoints_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is attached")
    f, kw = _pointwise(ht)
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.propagate_adjoints(f, **kw)


@pytest.mark.gpu
def test_tiled_group_gradient_on_the_card():
    """On the card the forward launches K1 and the gradient equals the
    CPU's (the plain version's) within rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ft, kw = _tiled(ht, param=True)
    want = ht.propagate_adjoints(ft, device="cpu", **kw)
    launches = gk.launches
    got = ht.propagate_adjoints(ft, **kw)
    assert gk.launches == launches + 1
    _check(want, got)

"""The port's models (halide_tpu_torch.models) and its resnet_50 app
against the JAX package's and numpy: the tiny network of
tests/test_apps.py (layers (1,1,1,1), width 8, 10 classes, 32x32, batch 2)
at the app's tolerance (rtol 5e-3, atol 1e-5), the lowering of every
update, and each layer builder of models/nn beside its JAX twin at a
small size (rtol 1e-5)."""
import numpy as np
import pytest
import torch

import halide_tpu as hl
import halide_tpu_torch as ht
from halide_tpu.apps import get as jax_get
from halide_tpu.models import nn as jnn
from halide_tpu_torch import updates
from halide_tpu_torch.apps import get as torch_get
from halide_tpu_torch.models import nn as tnn

TINY = dict(layers=(1, 1, 1, 1), width=8, classes=10, image=32, batch=2)


def test_resnet_tiny_matches_jax_and_numpy():
    tapp = torch_get("resnet_50")(**TINY)
    data = tapp.make_inputs(0)
    tapp.bind(data, "cpu")
    updates._last_reduce_path.clear()
    got = tapp.realize("cpu").to_numpy()
    paths = dict(updates._last_reduce_path)
    japp = jax_get("resnet_50")(**TINY)
    jdata = japp.make_inputs(0)
    for k in data:
        np.testing.assert_array_equal(data[k], jdata[k])   # same weights
    japp.bind(jdata)
    want = np.asarray(japp.realize().to_numpy())
    golden = tapp.reference(**data)
    assert got.shape == want.shape == golden.shape == (2, 10)
    assert got.dtype == np.float32
    for ref in (want, golden):
        np.testing.assert_allclose(got, ref, rtol=tapp.tolerance,
                                   atol=tapp.atol)
    assert (tapp.tolerance, tapp.atol) == (5e-3, 1e-5)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)
    # the logits (fc's output) against numpy's, normwise at the app's rtol
    from halide_tpu_torch.pipeline import gather_graph
    fc = next(f for f in gather_graph(tapp.pipeline.outputs).funcs
              if f.name == "fc")
    lg = ht.Pipeline(fc).realize([10, 2], device="cpu").to_numpy()
    lg_ref = tapp.logits_reference(**data)
    assert np.abs(lg - lg_ref).max() <= \
        tapp.tolerance * np.abs(lg_ref).max()
    # every conv2d took the convolution path (strided 7x7 stem, strided
    # 3x3 and 1x1 downsamples among them)
    convs = {k: v for k, v in paths.items() if k != "fc"}
    assert len(convs) == 1 + 4 * 4 and set(convs.values()) == {"conv"}, \
        paths
    # fc's 2560-point grid is under the einsum path's floor
    # (eval_torch._EINSUM_MIN_FULL), in both packages
    from halide_tpu import updates as jupdates
    assert paths["fc"] == jupdates._last_reduce_path["fc"] == "dense"
    assert tapp.flops == japp.flops


def test_resnet_fc_takes_the_einsum_path_at_full_width():
    """The canonical network's fc: 2048 features to 1000 classes, batch
    4, above the einsum path's floor."""
    rng = np.random.default_rng(3)
    c, n = ht.Var("c"), ht.Var("n")
    pooled = ht.Func("pooled")
    feat = rng.standard_normal((4, 2048), np.float32)
    fb = ht.Buffer(feat)
    pooled[c, n] = fb[c, n]
    pooled.compute_root()
    w = rng.standard_normal((2048, 1000), np.float32) * np.float32(0.01)
    fcw = ht.ImageParam(ht.Float(32), 2, "fc_w")
    fcb = ht.ImageParam(ht.Float(32), 1, "fc_b")
    fcw.set(w)
    fcb.set(np.zeros(1000, np.float32))
    fc = tnn.dense("fc_full", pooled, fcw, fcb, 2048)
    got = fc.realize([1000, 4], device="cpu").to_numpy()
    assert updates._last_reduce_path["fc_full"] == "einsum"
    np.testing.assert_allclose(got, feat @ w, rtol=1e-4, atol=1e-5)


# ---- each layer builder against its JAX twin ----------------------------

def _fmap(m, name, arr):
    """An ImageParam holding np (n, y, x, c) -> (c, x, y, n) feature map."""
    p = m.ImageParam(m.Float(32), 4, name)
    p.set(arr)
    return p


def _vec(m, name, arr):
    p = m.ImageParam(m.Float(32), arr.ndim, name)
    p.set(arr)
    return p


def _conv(m, nn, d, stride):
    x = _fmap(m, "cv_in", d["x"])
    f = nn.conv2d("cv", nn.zero_pad("cv_zp", x, 9, 7), _vec(m, "cv_w",
                  d["w"]), _vec(m, "cv_b", d["b"]), 4, 6, 3, stride, 1)
    return f, [6, (9 - 1) // stride + 1, (7 - 1) // stride + 1, 2]


def _pool(m, nn, d):
    f = nn.max_pool("mp", _fmap(m, "mp_in", d["x"]), 3, 2, 9, 7)
    return f, [4, 4, 3, 2]


def _gap(m, nn, d):
    return nn.global_avg_pool("gap", _fmap(m, "gap_in", d["x"]), 9, 7), \
        [4, 2]


def _dense(m, nn, d):
    c, n = m.Var("c"), m.Var("n")
    src = m.Func("dn_src")
    inp = _vec(m, "dn_in", d["v"])
    src[c, n] = inp[c, n]
    src.compute_root()
    return nn.dense("dn", src, _vec(m, "dn_w", d["fw"]),
                    _vec(m, "dn_b", d["fb"]), 12), [5, 2]


def _softmax(m, nn, d):
    return nn.softmax("sm", _vec(m, "sm_in", d["v"]), 12), [12, 2]


def _bn_add(m, nn, d):
    x = _fmap(m, "ba_in", d["x"])
    a = nn.bn_relu("ba_bn", x, _vec(m, "ba_s", d["s"]),
                   _vec(m, "ba_o", d["o"]))
    return nn.add_relu("ba_add", a, x), [4, 9, 7, 2]


BUILDERS = {"conv2d": lambda m, nn, d: _conv(m, nn, d, 1),
            "conv2d_stride2": lambda m, nn, d: _conv(m, nn, d, 2),
            "max_pool": _pool, "global_avg_pool": _gap, "dense": _dense,
            "softmax": _softmax, "bn_relu_add_relu": _bn_add}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_nn_builder_matches_jax(name):
    rng = np.random.default_rng(7)
    d = {"x": rng.standard_normal((2, 7, 9, 4), np.float32),
         "w": rng.standard_normal((4, 3, 3, 6), np.float32),
         "b": rng.standard_normal(6, np.float32),
         "v": rng.standard_normal((2, 12), np.float32),
         "fw": rng.standard_normal((12, 5), np.float32),
         "fb": rng.standard_normal(5, np.float32),
         "s": rng.random(4, np.float32) + 0.5,
         "o": rng.standard_normal(4, np.float32)}
    tf, sizes = BUILDERS[name](ht, tnn, d)
    jf, jsizes = BUILDERS[name](hl, jnn, d)
    assert sizes == jsizes
    got = tf.realize(sizes, device="cpu").to_numpy()
    want = np.asarray(jf.realize(sizes).to_numpy())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if name.startswith("conv2d"):
        assert updates._last_reduce_path["cv"] == "conv"
    assert torch.isfinite(torch.from_numpy(got)).all()

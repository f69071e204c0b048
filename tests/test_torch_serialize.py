"""Pipeline serialization in both packages: the cases of
tests/test_serialize.py, and round trips across the packages. Both write
the same JSON (format 1): for blur, camera_pipe, iir_blur, hist and
compositing at small sizes, the text the JAX package writes is the text the
port writes once the object keys (which carry Python ids) are numbered in
order of appearance; the port realizes the JAX package's text (on the CPU)
to the JAX app's output, and the JAX package realizes the port's text to
the port's output, each under the app's own tolerance (bit for bit for the
integer apps)."""
import json
import re

import numpy as np
import pytest
import torch

import halide_tpu as hl
import halide_tpu_torch as ht
from halide_tpu.apps import get as jax_get
from halide_tpu_torch.apps import get as torch_get
from halide_tpu_torch.ops import group_kernel as gk

from test_torch_apps import _compare
from test_torch_basics import _realize


def _build_blur(m):
    x, y = m.Var("x"), m.Var("y")
    inp = m.ImageParam(m.UInt(16), 2, "input")
    p = m.Param(m.Int(32), "offset", 1)
    bx, by = m.Func("bx"), m.Func("by")
    clamped = m.repeat_edge(inp)
    bx[x, y] = (clamped[x - 1, y] + clamped[x, y] + clamped[x + p, y]) / 3
    by[x, y] = (bx[x, y - 1] + bx[x, y] + bx[x, y + 1]) / 3
    xo, yo, xi, yi = (m.Var(n) for n in "ab cd ef gh".split())
    by.tile(x, y, xo, yo, xi, yi, 32, 8)
    bx.compute_at(by, xo)
    return by, inp, p


def test_roundtrip_blur():
    """A tiled blur with a compute_at producer and a scalar Param: the
    deserialized pipeline equals the original in each package, and the
    port's goes through the group kernel's plan as the original does."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 1 << 14, (40, 56), np.uint16)
    outs = []
    for m in (hl, ht):
        by, inp, p = _build_blur(m)
        text = m.serialize_pipeline(m.Pipeline(by))
        pipe2, images, params = m.deserialize_pipeline(text)
        inp.set(img)
        p.set(1)
        ref = _realize(m, by, [56, 40]).to_numpy()
        plan0 = gk.last_plan
        gk.last_plan = None
        images["input"].set(img)
        params["offset"].set(1)
        out = _realize(m, pipe2, [56, 40]).to_numpy()
        np.testing.assert_array_equal(out, ref)
        if m is ht:
            assert gk.last_plan == plan0 and plan0["func"] == "by"
        # schedules survive a second round
        text2 = m.serialize_pipeline(pipe2)
        assert '"splits"' in text2 and '"func"' in text2
        outs.append(np.asarray(out))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_roundtrip_reduction():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 64, np.uint8)
    outs = []
    for m in (hl, ht):
        x = m.Var("x")
        inp = m.ImageParam(m.UInt(8), 1, "data")
        r = m.RDom(0, 64, "r")
        r.where(r.x % 2 == 0)
        hist = m.Func("hist")
        hist[x] = 0
        hist[m.i32(inp[r.x])] += 1
        cdf = m.Func("cdf")
        cdf[x] = hist[0]
        b = m.RDom(1, 255, "b")
        cdf[b.x] = cdf[b.x - 1] + hist[b.x]
        text = m.serialize_pipeline(m.Pipeline(cdf))
        pipe2, images, _ = m.deserialize_pipeline(text)
        inp.set(data)
        ref = _realize(m, cdf, [256]).to_numpy()
        images["data"].set(data)
        out = _realize(m, pipe2, [256]).to_numpy()
        np.testing.assert_array_equal(out, ref)
        outs.append(np.asarray(out))
    np.testing.assert_array_equal(outs[0], outs[1])
    cnt = np.bincount(data[::2], minlength=256)
    np.testing.assert_array_equal(outs[1], np.cumsum(cnt))


def canonical(text: str) -> dict:
    """The document with its object keys (f<id>, img<id>, param<id>,
    rdom<id>) and the RDoms' generated names (r<counter>, which each
    package counts on its own) numbered in order of first appearance."""
    names = {}

    def rename(mo):
        k = mo.group(1) + mo.group(2)
        if k not in names:
            names[k] = f"{mo.group(1)}#{len(names)}"
        return f'"{names[k]}{mo.group(3) or ""}"'
    return json.loads(re.sub(r'"(f|img|param|rdom|r)(\d+)(\$\w+)?"',
                             rename, text))


# (app, its size, the port's schedule options, the JAX package's env)
APPS = [
    ("blur", dict(width=96, height=64), {}, {}),
    ("camera_pipe", dict(out_width=64, out_height=32), {}, {}),
    ("iir_blur", dict(width=48, height=32), {}, {}),
    ("hist", dict(width=48, height=32), {}, {}),
    ("compositing", dict(width=64, height=48), {"kernel": False}, {}),
    # the kernel branch: a group of three members with div-indexed windows
    ("camera_pipe", dict(out_width=128, out_height=64),
     {"kernel": True, "tile": (64, 32)},
     {"HALIDE_TPU_CP_KERNEL": "1", "HALIDE_TPU_CP_TILE": "64x32"}),
]
IDS = ["blur", "camera_pipe", "iir_blur", "hist", "compositing",
       "camera_pipe_tiled"]


def _bind(images, params, app, data, device=None):
    """Bind a deserialized pipeline's inputs by name from make_inputs'
    dict: tensors on `device` for the port, numpy for the JAX package."""
    for name, ip in images.items():
        v = data[name]
        ip.set(v if device is None else torch.from_numpy(
            np.ascontiguousarray(v)).to(device))
    for name, pa in params.items():
        pa.set(data[name])


def _apps(name, size, port_kw, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    japp = jax_get(name)(**size)
    tapp = torch_get(name)(**size, **port_kw)
    data = japp.make_inputs(0)
    japp.bind(data)
    tapp.bind(data, "cpu")
    return japp, tapp, data


@pytest.mark.parametrize("name,size,port_kw,env", APPS,
                         ids=IDS)
def test_both_packages_write_the_same_text(name, size, port_kw, env,
                                           monkeypatch):
    japp, tapp, _data = _apps(name, size, port_kw, env, monkeypatch)
    assert canonical(ht.serialize_pipeline(tapp.pipeline)) == canonical(
        hl.serialize_pipeline(japp.pipeline))


@pytest.mark.parametrize("name,size,port_kw,env", APPS,
                         ids=IDS)
def test_port_realizes_the_jax_text(name, size, port_kw, env, monkeypatch):
    japp, tapp, data = _apps(name, size, port_kw, env, monkeypatch)
    want = np.asarray(japp.realize().to_numpy())
    pipe, images, params = ht.deserialize_pipeline(
        hl.serialize_pipeline(japp.pipeline))
    _bind(images, params, tapp, data, "cpu")
    got = pipe.realize(tapp.output_sizes, device="cpu").to_numpy()
    _compare(tapp, got, want)


@pytest.mark.parametrize("name,size,port_kw,env", APPS,
                         ids=IDS)
def test_jax_realizes_the_port_text(name, size, port_kw, env, monkeypatch):
    japp, tapp, data = _apps(name, size, port_kw, env, monkeypatch)
    want = tapp.realize("cpu").to_numpy()
    pipe, images, params = hl.deserialize_pipeline(
        ht.serialize_pipeline(tapp.pipeline))
    _bind(images, params, japp, data)
    got = np.asarray(pipe.realize(japp.output_sizes).to_numpy())
    _compare(tapp, got, want)


def test_tiled_text_plans_the_same_group():
    """blur under the README's tiled schedule, written by the port and read
    back: the realize plans the same group as the original's."""
    tapp = torch_get("blur")(width=96, height=64, tile=(40, 24))
    data = tapp.make_inputs(0)
    tapp.bind(data, "cpu")
    want = tapp.realize("cpu").to_numpy()
    plan0, gk.last_plan = gk.last_plan, None
    pipe, images, params = ht.deserialize_pipeline(
        ht.serialize_pipeline(tapp.pipeline))
    _bind(images, params, tapp, data, "cpu")
    np.testing.assert_array_equal(
        pipe.realize(tapp.output_sizes, device="cpu").to_numpy(), want)
    assert gk.last_plan == plan0
    assert gk.last_plan["members"] == ["blur_x"]

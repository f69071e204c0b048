"""The stencil-group kernel K1 with inline reductions in its members (the
JAX kernel evaluates them through eval_jnp._eval_reduce, its footprint pass
widening the scope by the RDom, pallas_group.py:302-311).

One tiled group holds a sum and a maximum over a 3 x 3 RDom, a sum over a
`where`-predicated RDom reading two other members, and an argmax over the
2-D RDom (its coordinates and value; integer data in [0, 4) makes ties),
and the output a minimum. On the CPU: the plan engages where the JAX
planner's does (a spy on `pallas_group.try_pallas_group`, as
tests/test_pallas.py:85-115); its plain version equals the JAX package
(f32 within rtol 1e-6, the two sum in other orders; i32 bit for bit); the
emitted source, built with g++, equals the plain version bit for bit (both
fold each reduction in RDom order, r.x innermost); `point_ops` counts a
reduction by hand. On the card (marked gpu) the kernel equals its plain
version bit for bit.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import halide_tpu_torch as ht
from halide_tpu_torch.ops import group_kernel as gk

H, W, TILE = 40, 70, (32, 16)


def reduce_group(m, a, tile=TILE, device="cpu"):
    """The group in package m over the input a (f32 or i32; the port's on
    `device`), output tiled by `tile`, every member computed at its tiles;
    tile None: untiled."""
    x, y = m.Var("x"), m.Var("y")
    xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
    T = m.Float(32) if a.dtype == np.float32 else m.Int(32)
    inp = m.ImageParam(T, 2, "rin")
    c = m.repeat_edge(inp)
    r = m.RDom(-1, 3, -1, 3, "rg")
    s, mx = m.Func("s_sum"), m.Func("s_max")
    w, am = m.Func("s_where"), m.Func("s_arg")
    s[x, y] = m.sum(c[x + r.x, y + r.y])
    mx[x, y] = m.maximum(c[x + r.x, y + r.y] * 2)
    rw = m.RDom(0, 5, "rw")
    rw.where(rw.x != 2)
    w[x, y] = m.sum(s[x + rw.x - 2, y] * mx[x, y + rw.x - 2])
    a3 = m.argmax(s[x + r.x, y + r.y])
    am[x, y] = m.cast(T, a3[0] * 3 + a3[1]) + a3[2]
    out = m.Func("rg_out")
    out[x, y] = w[x, y] + am[x, y] - m.minimum(s[x, y + r.y])
    if tile is not None:
        out.tile(x, y, xo, yo, xi, yi, tile[0], tile[1])
        for f in (s, mx, w, am):
            f.compute_at(out, xo)
    inp.set(m.Buffer(torch.from_numpy(a).to(device)) if m is ht
            else m.Buffer(a))
    return m.Pipeline(out)


def _data(dtype):
    rng = np.random.default_rng(0)
    if dtype == "i32":
        return rng.integers(0, 4, (H, W)).astype(np.int32)
    return rng.random((H, W), np.float32)


def _port_group(a):
    """Realize the port's group on the CPU; -> (pipeline, output, the group
    call made again)."""
    p = reduce_group(ht, a)
    before = sum(gk.rejects.values())
    gk.last_plan = None
    out = p.realize([W, H], device="cpu").to_numpy()
    assert sum(gk.rejects.values()) == before, dict(gk.rejects)
    assert gk.last_plan["members"] == ["s_sum", "s_max", "s_where", "s_arg"]
    return p, out, gk.group_call(p, "cpu")


def _jax_group(a):
    """The JAX package's realize, whether its group kernel engaged, and
    its planner's last reject (imported here: the tests marked gpu run
    where the JAX package is not installed)."""
    import halide_tpu as hl
    from halide_tpu.ops import pallas_group as pg
    calls = []
    orig = pg.try_pallas_group

    def spy(*args, **kw):
        r = orig(*args, **kw)
        calls.append(r is not None)
        return r
    pg.try_pallas_group = spy
    try:
        out = np.asarray(reduce_group(hl, a).realize([W, H]).to_numpy())
    finally:
        pg.try_pallas_group = orig
    return out, calls, pg._last_reject


@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_reduce_group_plan_engages_and_matches_jax(dtype):
    """f32: both planners take the group. i32: the port's does, the JAX
    one rejects it for a TPU reason (jnp.sum promotes int32 to int64 with
    x64 on, and Mosaic takes no 64-bit values in a kernel), and runs it
    whole-array; the values agree bit for bit all the same."""
    a = _data(dtype)
    _p, got, _call = _port_group(a)
    want, engaged, reject = _jax_group(a)
    if dtype == "f32":
        assert engaged == [True]
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        assert engaged == [False] and "64-bit" in reject
        np.testing.assert_array_equal(got, want)
    whole = reduce_group(ht, a, tile=None).realize([W, H], device="cpu")
    np.testing.assert_allclose(got, whole.to_numpy(), rtol=1e-6)


def _host_build(plan, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the emitted source")
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
    return fn


@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_emitted_reductions_on_host_match_plain_version(dtype, tmp_path):
    """The emitted loops (r.x innermost, the accumulator from the
    identity, the `where` points skipped, argmax's tie order), built with
    g++, equal the plain version point by point."""
    _p, out, (plan, inputs, rmins, params, _r) = _port_group(_data(dtype))
    fn = _host_build(plan, tmp_path)
    host = torch.empty(tuple(reversed(plan.extents)),
                       dtype=torch.from_numpy(out).dtype)
    assert fn(*gk.launch_args(plan, [t.contiguous() for t in inputs],
                              rmins, host)) == 0
    plain = gk.run_plain(plan, inputs, rmins, params, torch.device("cpu"))
    assert torch.equal(host, plain)
    assert torch.equal(plain, torch.from_numpy(out))
    assert "for (int r" in plan.source and "hl_arg_better<true>" in \
        plan.source


def test_point_ops_counts_a_reduction_by_its_points():
    """A reduction counts its value's operations at every point of the
    RDom plus one combine a point, in the value's type; a predicate's
    operations count at every point too."""
    x = ht.Var("x")
    inp = ht.ImageParam(ht.Float(32), 1, "pin")
    r = ht.RDom(0, 7, 0, 3, "pr")
    e = ht.sum(inp[x + r.x] * 2.0 + 1.0)                  # 2 ops + 1
    assert gk.point_ops(e) == (21 * 3, 0)
    ri = ht.RDom(0, 5, "pi")
    ri.where(ri.x != 2)                                    # 1 int op
    e2 = ht.maximum(inp[x + ri.x] - 1.0) + 3.0             # 1 op + 1, + 1
    assert gk.point_ops(e2) == (5 * 2 + 1, 5)
    ii = ht.ImageParam(ht.Int(32), 1, "pii")
    e3 = ht.argmax(ii[x + r.x + r.y])[0]                   # 1 compare a pt
    assert gk.point_ops(e3) == (0, 21)


def test_point_ops_of_nl_means_members():
    """nl_means's box sums (patch 7, search 7): d sums the three channels'
    squared differences (a sub and a pow each, and a combine: 9), blur_d_y
    and blur_d seven points each (7)."""
    from halide_tpu_torch.apps import get
    app = get("nl_means")(width=256, height=64)
    vals = {f.name: f._defs[0].values[0]
            for f in ht.pipeline.gather_graph(app.pipeline.outputs).funcs}
    expanded = {k: gk._inline_expand(v) for k, v in vals.items()}
    assert gk.point_ops(expanded["d"]) == (9, 0)
    assert gk.point_ops(expanded["blur_d_y"]) == (7, 0)
    assert gk.point_ops(expanded["blur_d"]) == (7, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_reduce_group_kernel_matches_plain_version_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = reduce_group(ht, _data(dtype), device="cuda")
    launches = gk.launches
    out = p.realize([W, H])
    assert gk.launches == launches + 1
    plan, inputs, rmins, params, _realz = gk.group_call(p)
    plain = gk.run_plain(plan, inputs, rmins, params, inputs[0].device)
    torch.cuda.synchronize()
    assert torch.equal(out.data, plain)


def test_nl_means_group_on_host_matches_plain_version(tmp_path):
    """nl_means's box-sum group (256 x 64, patch 5, search 5): the g++
    build of its emitted source equals the plain version bit for bit
    (pow(x, 2.0) is x * x on both sides)."""
    from halide_tpu_torch.apps import get
    app = get("nl_means")(width=256, height=64, patch_size=5, search_area=5)
    app.bind(app.make_inputs(0), "cpu")
    gk.last_plan = None
    app.realize("cpu")
    assert gk.last_plan["func"] == "blur_d"
    plan, inputs, rmins, params, _r = gk.group_call(app.pipeline, "cpu")
    fn = _host_build(plan, tmp_path)
    host = torch.empty(tuple(reversed(plan.extents)), dtype=torch.float32)
    assert fn(*gk.launch_args(plan, [t.contiguous() for t in inputs],
                              rmins, host)) == 0
    plain = gk.run_plain(plan, inputs, rmins, params, torch.device("cpu"))
    assert torch.equal(host, plain)

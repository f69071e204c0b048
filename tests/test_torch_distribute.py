"""The port's sharded realize (halide_tpu_torch.parallel) against the JAX
package's (halide_tpu.parallel) and numpy: the cases of
tests/test_distribute.py, each on an 8-slot "cpu" mesh of the port beside
the JAX package's virtual 8-device CPU mesh (tests/conftest.py), at that
file's tolerances (rtol 1e-6 for float outputs, integer outputs bit for
bit); then every CompileError the port keeps, the plan cache around a
sharded realize, K1's plan on every shard, the dry run, and realize's
signature in the JAX package's order."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import halide_tpu as hl
import halide_tpu_torch as ht
from halide_tpu_torch.parallel import Mesh
from halide_tpu_torch.parallel import distribute as tdist

N_SLOTS = 8


def _meshes(n, axis="shards"):
    """(the JAX package's mesh, the port's) of n shards."""
    assert len(jax.devices()) >= n
    return (JaxMesh(np.array(jax.devices()[:n]), (axis,)),
            Mesh(["cpu"] * n, (axis,)))


def _outs(r):
    """A realize's outputs as a list of numpy arrays."""
    if hasattr(r, "to_numpy"):
        return [np.asarray(r.to_numpy())]
    return [np.asarray(b.to_numpy()) for b in r]


def _both(build, sizes, n, pick_var, rtol=None, exact=False):
    """Realize build(m) unsharded and sharded over n shards in both
    packages; hold each sharded output against its unsharded one, the
    port's against the JAX package's, and return the port's outputs."""
    res = {}
    for m, mesh, kw in ((hl, _meshes(n)[0], {}),
                        (ht, _meshes(n)[1], {"device": "cpu"})):
        outs = build(m)
        outs = outs if isinstance(outs, tuple) else (outs,)
        ref = _outs(m.Pipeline(list(outs)).realize(sizes, **kw))
        outs2 = build(m)
        outs2 = outs2 if isinstance(outs2, tuple) else (outs2,)
        outs2[0].distribute(pick_var(outs2[0]), "shards")
        got = _outs(m.Pipeline(list(outs2)).realize(sizes, mesh=mesh,
                                                     **kw))
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            if exact:
                np.testing.assert_array_equal(g, r)
            else:
                np.testing.assert_allclose(g, r, rtol=rtol, atol=rtol)
        res[m] = got
    for g, j in zip(res[ht], res[hl]):
        assert g.dtype == j.dtype
        if exact:
            np.testing.assert_array_equal(g, j)
        else:
            np.testing.assert_allclose(g, j, rtol=rtol, atol=rtol)
    return res[ht]


def _y(f):
    return f._args[1]


# ---- the cases of tests/test_distribute.py -------------------------------

def _rows_build(m, W):
    def build(inp):
        x, y = m.Var("x"), m.Var("y")
        cl = m.Func("cl")
        cl[x, y] = inp[m.clamp(x, 0, W - 1), y]
        bx, by = m.Func("bx"), m.Func("by")
        bx[x, y] = (cl[x - 1, y] + cl[x, y] + cl[x + 1, y]) / 3
        by[x, y] = (bx[x, y - 1] + bx[x, y] + bx[x, y + 1]) / 3
        return m.Pipeline(by)
    return build


def test_sharded_rows_matches_single_device():
    from jax.sharding import NamedSharding, PartitionSpec as P
    from halide_tpu.parallel import sharded_realize_rows as jax_rows
    from halide_tpu_torch.parallel import sharded_realize_rows

    n = N_SLOTS
    W, Hs = 32, 4
    H = Hs * n
    jmesh, tmesh = _meshes(n, "y")
    img = np.random.default_rng(0).integers(0, 1 << 12, size=(H, W),
                                            dtype=np.uint16)
    got = sharded_realize_rows(_rows_build(ht, W), W, H, tmesh, "y",
                               halo=1)(torch.from_numpy(img)).numpy()
    jfn = jax_rows(_rows_build(hl, W), W, H, jmesh, "y", halo=1)
    want = np.asarray(jfn(jax.device_put(
        jax.numpy.asarray(img), NamedSharding(jmesh, P("y", None)))))
    np.testing.assert_array_equal(got, want)
    # single-device reference: the same front end, repeat_edge in y
    x, y = ht.Var("x"), ht.Var("y")
    cl = ht.repeat_edge(ht.Buffer(img))
    bx, by = ht.Func("bx1"), ht.Func("by1")
    bx[x, y] = (cl[x - 1, y] + cl[x, y] + cl[x + 1, y]) / 3
    by[x, y] = (bx[x, y - 1] + bx[x, y] + bx[x, y + 1]) / 3
    np.testing.assert_array_equal(
        got, by.realize([W, H], device="cpu").to_numpy())
    with pytest.raises(ValueError):
        sharded_realize_rows(_rows_build(ht, W), W, H + 1, tmesh, "y", 1)


def test_port_dryrun():
    from halide_tpu_torch.parallel.dryrun import dryrun_multichip
    rep = dryrun_multichip(4, "cpu")
    assert rep["train"]["mesh"] == {"data": 2, "model": 2}
    assert rep["rows"]["shards"] == 4 and rep["hist"]["shards"] == 4


def test_port_dryrun_needs_a_device():
    from halide_tpu_torch.parallel.dryrun import dryrun_multichip
    if torch.cuda.is_available():
        pytest.skip("a card is present: None means the card")
    with pytest.raises(RuntimeError, match="CUDA device"):
        dryrun_multichip(2)


def test_distribute_directive_stencil():
    n = 4
    W, H = 64, 8 * n
    img = np.random.default_rng(3).random((H, W)).astype(np.float32)

    def build(m):
        x, y = m.Var("x"), m.Var("y")
        inp = m.ImageParam(m.Float(32), 2, "dd_in")
        inp.set(img)
        cl = m.repeat_edge(inp)
        bx, by = m.Func("dd_bx"), m.Func("dd_by")
        bx[x, y] = (cl[x - 1, y] + cl[x, y] + cl[x + 1, y]) / 3.0
        by[x, y] = (bx[x, y - 1] + bx[x, y] + bx[x, y + 1]) / 3.0
        bx.compute_root()
        return by

    _both(build, [W, H], n, _y, rtol=1e-6)


def test_distribute_two_shards_forward_stencil():
    # with a 2-shard mesh EVERY shard is an edge shard: halo inference
    # must not take shard 1 for an interior one (its high-side clamp
    # would truncate h_hi to 0 and shard 0 never get its y+1 halo)
    W, H = 16, 8
    img = np.random.default_rng(7).random((H, W)).astype(np.float32)

    def build(m):
        x, y = m.Var("x"), m.Var("y")
        inp = m.ImageParam(m.Float(32), 2, "d2_in")
        inp.set(img)
        cl = m.repeat_edge(inp)
        f = m.Func("d2_out")
        f[x, y] = cl[x, y + 1] * 2.0 + cl[x, y + 2]
        return f

    got = _both(build, [W, H], 2, _y, rtol=1e-6)
    p = np.pad(img, ((0, 2), (0, 0)), mode="edge")
    np.testing.assert_allclose(got[0], p[1:-1] * 2 + p[2:], rtol=1e-6)


def test_distribute_replicates_shard_independent_inputs():
    n = 4
    W, H = 32, 8 * n
    rng = np.random.default_rng(4)
    img = (rng.random((H, W)) * 255).astype(np.float32)
    lut = np.sqrt(np.arange(256, dtype=np.float32))

    def build(m):
        x, y = m.Var("x"), m.Var("y")
        inp = m.ImageParam(m.Float(32), 2, "dr_in")
        lutp = m.ImageParam(m.Float(32), 1, "dr_lut")
        inp.set(img)
        lutp.set(lut)
        cl = m.repeat_edge(inp)
        f = m.Func("dr_out")
        f[x, y] = lutp[m.clamp(m.i32(inp[x, y]), 0, 255)] + cl[x, y - 1]
        return f

    _both(build, [W, H], n, _y, rtol=1e-6)


def _rowsum(m, img, name, rdom_name):
    H = img.shape[0]
    x = m.Var("x")
    inp = m.ImageParam(m.Float(32), 2, name + "_in")
    inp.set(img)
    r = m.RDom(0, H, rdom_name)
    f = m.Func(name + "_out")
    f[x] = 0.0
    f[x] += inp[x, r.x]
    return f


def _rowmax(m, img, name, rdom_name):
    H = img.shape[0]
    x = m.Var("x")
    inp = m.ImageParam(m.Float(32), 2, name + "_in")
    inp.set(img)
    r = m.RDom(0, H, rdom_name)
    f = m.Func(name + "_out")
    f[x] = m.Float(32).min_value()
    f[x] = m.max(f[x], inp[x, r.x])
    return f


def _rv(f):
    return f._defs[-1].rdom.dims[0]


def test_distribute_sharded_reduction_rowsum():
    n = 4
    W, H = 32, 8 * n
    img = np.random.default_rng(11).integers(0, 100, (H, W)).astype(
        np.float32)
    got = _both(lambda m: _rowsum(m, img, "rs", "rr"), [W], n, _rv,
                rtol=1e-6)
    np.testing.assert_allclose(got[0], img.sum(axis=0), rtol=1e-6)


def _hist(m, img, B, name="hg"):
    H, W = img.shape
    b = m.Var("b")
    inp = m.ImageParam(m.Int(32), 2, name + "_in")
    inp.set(img)
    r = m.RDom(0, W, 0, H, name + "r")
    h = m.Func(name + "_out")
    h[b] = 0
    h[m.clamp(inp[r.x, r.y], 0, B - 1)] += 1
    return h


def test_distribute_sharded_histogram():
    n = 4
    W, H, B = 32, 8 * n, 16
    img = np.random.default_rng(12).integers(0, B, (H, W)).astype(np.int32)
    got = _both(lambda m: _hist(m, img, B), [B], n,
                lambda f: f._defs[1].rdom.dims[1], exact=True)
    np.testing.assert_array_equal(got[0],
                                  np.bincount(img.ravel(), minlength=B))


def test_distribute_sharded_max_reduction():
    n = 4
    W, H = 16, 4 * n
    img = np.random.default_rng(13).random((H, W)).astype(np.float32)
    got = _both(lambda m: _rowmax(m, img, "mx", "mr"), [W], n, _rv,
                rtol=1e-6)
    np.testing.assert_allclose(got[0], img.max(axis=0), rtol=1e-6)


def test_distribute_multi_output():
    n = 4
    W, H = 16, 8 * n
    img = np.random.default_rng(14).random((H, W)).astype(np.float32)

    def build(m):
        x, y = m.Var("x"), m.Var("y")
        inp = m.ImageParam(m.Float(32), 2, "mo_in")
        inp.set(img)
        cl = m.repeat_edge(inp)
        f1, f2 = m.Func("mo_a"), m.Func("mo_b")
        f1[x, y] = (cl[x, y - 1] + cl[x, y + 1]) * 0.5
        f2[x, y] = cl[x, y] * 2.0
        return f1, f2

    got = _both(build, [W, H], n, _y, rtol=1e-6)
    np.testing.assert_allclose(got[1], img * 2.0, rtol=1e-6)


def test_distribute_uneven_extent():
    # H=52 over 8 shards: 7-row shards, the last one 3 rows of pad
    n = N_SLOTS
    W, H = 16, 7 * n - 4
    img = np.random.default_rng(21).random((H, W)).astype(np.float32)

    def build(m):
        x, y = m.Var("x"), m.Var("y")
        inp = m.ImageParam(m.Float(32), 2, "ue_in")
        inp.set(img)
        cl = m.repeat_edge(inp)
        f = m.Func("ue_out")
        f[x, y] = (cl[x, y - 1] + cl[x, y] + cl[x, y + 1]) / 3.0
        return f

    got = _both(build, [W, H], n, _y, rtol=1e-6)
    assert got[0].shape == (H, W)


def test_distribute_tuple_output():
    n = 4
    W, H = 16, 8 * n
    img = np.random.default_rng(22).random((H, W)).astype(np.float32)

    def build(m):
        x, y = m.Var("x"), m.Var("y")
        inp = m.ImageParam(m.Float(32), 2, "tp_in")
        inp.set(img)
        cl = m.repeat_edge(inp)
        f = m.Func("tp_out")
        f[x, y] = (cl[x, y - 1] + cl[x, y + 1], cl[x, y] * 3.0)
        return f

    got = _both(build, [W, H], n, _y, rtol=1e-6)
    assert len(got) == 2
    np.testing.assert_allclose(got[1], img * 3.0, rtol=1e-6)


def test_distribute_uneven_tuple_combined():
    n = 4
    W, H = 16, 4 * n + 3
    img = np.random.default_rng(23).random((H, W)).astype(np.float32)

    def build(m):
        x, y = m.Var("x"), m.Var("y")
        inp = m.ImageParam(m.Float(32), 2, "ut_in")
        inp.set(img)
        cl = m.repeat_edge(inp)
        f = m.Func("ut_out")
        f[x, y] = (cl[x, y + 1] - cl[x, y - 1], cl[x, y] + 1.0)
        return f

    got = _both(build, [W, H], n, _y, rtol=1e-6)
    assert got[0].shape == (H, W) and got[1].shape == (H, W)


def test_distribute_rvar_uneven_extent():
    # a 10-row reduction on 8 shards: chunks of 2, the pad iterations
    # masked to the identity by the sharded 0/1 mask input
    n = N_SLOTS
    W, H = 32, 10
    img = np.random.default_rng(21).integers(0, 100, (H, W)).astype(
        np.float32)
    got = _both(lambda m: _rowsum(m, img, "ru", "rru"), [W], n, _rv,
                rtol=1e-6)
    np.testing.assert_allclose(got[0], img.sum(axis=0), rtol=1e-6)


def test_distribute_rvar_uneven_max():
    n = N_SLOTS
    W, H = 16, 11
    img = np.random.default_rng(22).random((H, W)).astype(np.float32)
    got = _both(lambda m: _rowmax(m, img, "rumx", "rmu"), [W], n, _rv,
                rtol=1e-6)
    np.testing.assert_allclose(got[0], img.max(axis=0), rtol=1e-6)


def test_distribute_rvar_uneven_leaves_the_input_as_bound():
    """The uneven reduction edge-pads its sharded input for the shards
    only: afterwards the ImageParam holds the caller's Buffer, with its
    rows, and an unsharded realize reads it as before."""
    n = N_SLOTS
    W, H = 32, 10
    img = np.random.default_rng(23).integers(0, 100, (H, W)).astype(
        np.float32)
    f = _rowsum(ht, img, "rb", "rrb")
    inp = next(iter(ht.pipeline.gather_graph([f]).inputs.values()))
    bound = inp.get()
    f.distribute(_rv(f), "shards")
    p = ht.Pipeline(f)
    got = p.realize([W], mesh=_meshes(n)[1]).to_numpy()
    np.testing.assert_allclose(p.realize([W], mesh=_meshes(n)[1])
                               .to_numpy(), got, rtol=0, atol=0)
    assert inp.get() is bound
    assert tuple(inp.get().data.shape) == (H, W)
    assert inp.get().height() == H
    np.testing.assert_allclose(got, img.sum(axis=0), rtol=1e-6)
    np.testing.assert_allclose(p.realize([W], device="cpu").to_numpy(),
                               img.sum(axis=0), rtol=1e-6)


def _buffer_stencil(H, W, img):
    x, y = ht.Var("x"), ht.Var("y")
    buf = ht.Buffer(torch.from_numpy(img), name="bi_in")
    cl = ht.repeat_edge(buf)
    bx, by = ht.Func("bi_bx"), ht.Func("bi_by")
    bx[x, y] = cl[x - 1, y] + cl[x, y] + cl[x + 1, y]
    by[x, y] = bx[x, y - 1] + 2 * bx[x, y] + bx[x, y + 1]
    by.distribute(y, "shards")
    return buf, by, [W, H]


def _buffer_rowsum(H, W, img):
    buf = ht.Buffer(torch.from_numpy(img), name="bir_in")
    x = ht.Var("x")
    r = ht.RDom(0, H, "bir")
    f = ht.Func("bir_out")
    f[x] = 0
    f[x] += buf[x, r.x]
    f.distribute(r.x, "shards")
    return buf, f, [W]


def _stencil_np(img):
    p = np.pad(img, 1, mode="edge")
    bxn = p[:, :-2] + p[:, 1:-1] + p[:, 2:]
    return bxn[:-2] + 2 * bxn[1:-1] + bxn[2:]


@pytest.mark.parametrize("build,golden,H", [
    (_buffer_stencil, _stencil_np, 32),
    (_buffer_stencil, _stencil_np, 30),
    (_buffer_rowsum, lambda img: img.sum(axis=0), 11)],
    ids=["stencil", "stencil_uneven", "rowsum_uneven"])
def test_distribute_buffer_input_raises(build, golden, H):
    """A sharded input that is a Buffer, not an ImageParam: its bounds are
    constants in the pipeline (repeat_edge's clamp), which a shard cannot
    rebind to its slab, so the sharded realize raises, leaves the Buffer
    as it was, and the unsharded realize matches numpy after it."""
    W = 24
    img = np.random.default_rng(24).integers(0, 1 << 12, (H, W)).astype(
        np.int32)
    buf, f, sizes = build(H, W, img)
    data = buf.data
    p = ht.Pipeline(f)
    with pytest.raises(ht.CompileError, match="is a Buffer"):
        p.realize(sizes, mesh=_meshes(4)[1])
    assert buf.data is data and tuple(buf._mins) == (0, 0)
    np.testing.assert_array_equal(p.realize(sizes, device="cpu").to_numpy(),
                                  golden(img))


def test_distribute_constant_bound_on_the_sharded_dim_raises():
    """A clamp to the global extent written by hand on the sharded dim
    keeps its constants in every shard's coordinates, so a shard would read
    its own first row for its top halo: the sharded realize raises, keeps
    no plan for it, and the same stencil with repeat_edge shards."""
    H, W = 32, 16
    img = np.random.default_rng(26).integers(0, 100, (H, W)).astype(
        np.int32)
    x, y = ht.Var("x"), ht.Var("y")
    inp = ht.ImageParam(ht.Int(32), 2, "cb_in")
    inp.set(img)
    f = ht.Func("cb_f")
    f[x, y] = (inp[x, ht.clamp(y - 1, 0, H - 1)] + inp[x, y]
               + inp[x, ht.clamp(y + 1, 0, H - 1)])
    f.distribute(y, "shards")
    p = ht.Pipeline(f)
    for _ in range(2):
        with pytest.raises(ht.CompileError, match="not by a constant"):
            p.realize([W, H], mesh=_meshes(4)[1])
        assert not p._plan_cache
    pe = np.pad(img, ((1, 1), (0, 0)), mode="edge")
    want = pe[:-2] + pe[1:-1] + pe[2:]
    np.testing.assert_array_equal(p.realize([W, H], device="cpu")
                                  .to_numpy(), want)
    cl = ht.repeat_edge(inp)
    g = ht.Func("cb_g")
    g[x, y] = cl[x, y - 1] + cl[x, y] + cl[x, y + 1]
    g.distribute(y, "shards")
    np.testing.assert_array_equal(
        ht.Pipeline(g).realize([W, H], mesh=_meshes(4)[1]).to_numpy(), want)


# ---- every CompileError the port keeps ----------------------------------

def _ce_output_dim(m):
    x, y = m.Var("x"), m.Var("y")
    f1, f2 = m.Func("ce1_a"), m.Func("ce1_b")
    f1[x, y] = x + y
    f2[y, x] = x - y
    f1.distribute(y, "shards")
    return m.Pipeline([f1, f2]), [8, 8]


def _ce_halo(m):
    x, y = m.Var("x"), m.Var("y")
    inp = m.ImageParam(m.Float(32), 2, "ce2_in")
    inp.set(np.zeros((16, 8), np.float32))
    cl = m.repeat_edge(inp)
    f = m.Func("ce2")
    f[x, y] = cl[x, y - 5] + cl[x, y + 5]
    f.distribute(y, "shards")
    return m.Pipeline(f), [8, 16]


def _ce_extent(m):
    x, y = m.Var("x"), m.Var("y")
    inp = m.ImageParam(m.Float(32), 2, "ce3_in")
    inp.set(np.zeros((36, 8), np.float32))
    f = m.Func("ce3")
    f[x, y] = inp[x, y + 2]
    f.distribute(y, "shards")
    return m.Pipeline(f), [8, 32]


def _reduce_func(m, name, init, update, rows=16, cols=8, rd=None,
                 inp_rows=None, mins=None, extra=None):
    x = m.Var("x")
    inp = m.ImageParam(m.Float(32), 2, name + "_in")
    data = np.ones((inp_rows or rows, cols), np.float32)
    inp.set(data if mins is None else m.Buffer(data, mins=mins))
    r = rd if rd is not None else m.RDom(0, rows, name + "_r")
    f = m.Func(name)
    f[x] = init
    update(f, x, inp, r)
    if extra is not None:
        extra(f, x)
    f.distribute(r.x, "shards")
    return f


def _ce_multi_output(m):
    def upd(f, x, inp, r):
        f[x] += inp[x, r.x]
    f = _reduce_func(m, "ce4", 0.0, upd)
    g = m.Func("ce4_g")
    g[m.Var("x")] = 1.0
    return m.Pipeline([f, g]), [8]


def _ce_not_last(m):
    def upd(f, x, inp, r):
        f[x] += inp[x, r.x]
    f = _reduce_func(m, "ce6", 0.0, upd,
                     extra=lambda f, x: f.__setitem__(x, f[x] * 2.0))
    return m.Pipeline(f), [8]


def _ce_not_assoc(m):
    def upd(f, x, inp, r):
        f[x] = f[x] * 0.5 + inp[x, r.x]
    return m.Pipeline(_reduce_func(m, "ce7", 0.0, upd)), [8]


def _ce_no_collective(m):
    def upd(f, x, inp, r):
        f[x] = f[x] * inp[x, r.x]
    return m.Pipeline(_reduce_func(m, "ce8", 1.0, upd)), [8]


def _ce_init(m):
    def upd(f, x, inp, r):
        f[x] += inp[x, r.x]
    return m.Pipeline(_reduce_func(m, "ce9", 1.0, upd)), [8]


def _ce_static(m):
    p = m.Param(m.Int(32), "ce10_p")
    p.set(16)

    def upd(f, x, inp, r):
        f[x] += inp[x, r.x]
    return m.Pipeline(_reduce_func(m, "ce10", 0.0, upd,
                                   rd=m.RDom(0, p, "ce10_r"))), [8]


def _ce_two_dims(m):
    def upd(f, x, inp, r):
        f[x] += inp[r.x, r.x]
    return m.Pipeline(_reduce_func(m, "ce11", 0.0, upd, cols=16)), [8]


def _ce_no_advance(m):
    def upd(f, x, inp, r):
        f[x] += inp[x, 15 - r.x]
    return m.Pipeline(_reduce_func(m, "ce12", 0.0, upd)), [8]


def _ce_not_uniform(m):
    def upd(f, x, inp, r):
        f[x] += inp[x, (r.x * r.x) / 16]
    return m.Pipeline(_reduce_func(m, "ce13", 0.0, upd)), [8]


def _ce_span(m):
    def upd(f, x, inp, r):
        f[x] += inp[x, r.x]
    return m.Pipeline(_reduce_func(m, "ce14", 0.0, upd,
                                   inp_rows=24)), [8]


def _ce_reduce_halo(m):
    def upd(f, x, inp, r):
        f[x] += inp[x, r.x]
    return m.Pipeline(_reduce_func(m, "ce15", 0.0, upd,
                                   mins=(0, 5))), [8]


CASES = {
    "output_dim": (_ce_output_dim, 4, "must carry dim"),
    "spatial_halo": (_ce_halo, 8, "wider than the shard extent"),
    "input_extent": (_ce_extent, 4, "!= output extent"),
    "single_output": (_ce_multi_output, 4, "single-output pipelines"),
    "not_last": (_ce_not_last, 4, "must be the last"),
    "not_associative": (_ce_not_assoc, 4, "not a recognized associative"),
    "no_collective": (_ce_no_collective, 4, "no collective for op"),
    "init_identity": (_ce_init, 4, "init value must be the combine"),
    "static_bounds": (_ce_static, 4, "must be static ints"),
    "two_dims": (_ce_two_dims, 4, "more than one dim"),
    "no_advance": (_ce_no_advance, 4, "does not advance"),
    "not_uniform": (_ce_not_uniform, 4, "does not shift uniformly"),
    "span": (_ce_span, 4, "exceeds the sharded span"),
    "reduce_halo": (_ce_reduce_halo, 8, "reduction halo wider"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_distribute_compile_errors(case):
    """Each CompileError of the port's distribute, with the JAX package's
    message under the same pipeline."""
    build, n, msg = CASES[case]
    jmesh, tmesh = _meshes(n)
    for m, mesh, kw in ((ht, tmesh, {"device": "cpu"}), (hl, jmesh, {})):
        pipe, sizes = build(m)
        with pytest.raises(m.CompileError, match=msg):
            pipe.realize(sizes, mesh=mesh, **kw)


def test_distribute_restores_the_update_after_an_error():
    """A refused uneven reduction leaves its update and RDom as they were:
    the pipeline realizes unsharded afterwards."""
    f = _reduce_func(ht, "ce16", 0.0,
                     lambda f, x, inp, r: f.__setitem__(
                         x, f[x] + inp[x, r.x]), rows=10, inp_rows=20)
    vals = list(f._defs[-1].values)
    with pytest.raises(ht.CompileError, match="exceeds the sharded span"):
        ht.Pipeline(f).realize([8], mesh=Mesh(["cpu"] * 4, "shards"))
    assert f._defs[-1].values == vals
    np.testing.assert_array_equal(
        ht.Pipeline(f).realize([8], device="cpu").to_numpy(), 10.0)


def test_distribute_unknown_rvar():
    f = _rowsum(ht, np.ones((8, 4), np.float32), "ce17", "ce17r")
    with pytest.raises(ht.CompileError, match="has no reduction var"):
        tdist.distributed_realize(ht.Pipeline(f), [4],
                                  Mesh(["cpu"] * 2, "s"), "s", "nope")


# ---- the plan cache, K1 on every shard, realize's signature -------------

def _blur_tiled(m, img, tile=(32, 8)):
    x, y = m.Var("x"), m.Var("y")
    xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
    inp = m.ImageParam(m.UInt(16), 2, "pc_in")
    inp.set(img)
    cl = m.repeat_edge(inp)
    bx, by = m.Func("pc_bx"), m.Func("pc_by")
    bx[x, y] = (cl[x - 1, y] + cl[x, y] + cl[x + 1, y]) / 3
    by[x, y] = (bx[x, y - 1] + bx[x, y] + bx[x, y + 1]) / 3
    by.tile(x, y, xo, yo, xi, yi, *tile)
    bx.compute_at(by, xo)
    return by


def test_shard_runs_leave_the_plan_cache_to_the_unsharded_realize():
    """The shard program is cached beside the unsharded one, under its
    dummies' key: a second sharded realize plans nothing, and the
    unsharded realize is served its own plan, before and after, in either
    order."""
    H, W = 64, 48
    img = np.random.default_rng(5).integers(0, 1 << 12, (H, W), np.uint16)
    by = _blur_tiled(ht, img)
    by.distribute(by._args[1], "shards")
    p = ht.Pipeline(by)
    mesh = Mesh(["cpu"] * 4, "shards")
    whole = p.realize([W, H], device="cpu").to_numpy()
    assert len(p._plan_cache) == 1
    sharded = p.realize([W, H], mesh=mesh).to_numpy()
    assert len(p._plan_cache) == 2          # the shard program, once
    np.testing.assert_array_equal(sharded, whole)
    np.testing.assert_array_equal(p.realize([W, H], mesh=mesh).to_numpy(),
                                  whole)
    assert len(p._plan_cache) == 2
    np.testing.assert_array_equal(p.realize([W, H], device="cpu")
                                  .to_numpy(), whole)
    assert len(p._plan_cache) == 2
    # and the other order: a sharded realize first
    by2 = _blur_tiled(ht, img)
    by2.distribute(by2._args[1], "shards")
    p2 = ht.Pipeline(by2)
    np.testing.assert_array_equal(p2.realize([W, H], mesh=mesh)
                                  .to_numpy(), whole)
    assert len(p2._plan_cache) == 1
    np.testing.assert_array_equal(p2.realize([W, H], device="cpu")
                                  .to_numpy(), whole)
    assert len(p2._plan_cache) == 2


def test_distribute_tiled_group_plans_k1_on_every_shard(monkeypatch):
    """A tiled group sharded over 4 shards: K1's plan is made once, on
    shard-0 coordinates (mins below zero, the shard's extent), and taken
    by every shard; each shard's plain version of K1 equals the unsharded
    output's rows, and the whole equals the JAX package's sharded
    realize."""
    from halide_tpu_torch.ops import group_kernel as gk
    H, W, n = 64, 48, 4
    img = np.random.default_rng(6).integers(0, 1 << 12, (H, W), np.uint16)
    taken = []
    orig = gk.try_group

    def spy(f, box, *a, **kw):
        r = orig(f, box, *a, **kw)
        taken.append((r is not None, [(iv.lo, iv.hi) for iv in box.dims]))
        return r

    monkeypatch.setattr(gk, "try_group", spy)
    want = ht.Pipeline(_blur_tiled(ht, img)).realize(
        [W, H], device="cpu").to_numpy()
    taken.clear()
    got = _both(lambda m: _blur_tiled(m, img), [W, H], n, _y, exact=True)
    np.testing.assert_array_equal(got[0], want)
    # unsharded in _both, then one K1 group per shard, all in shard-0
    # coordinates
    shard = [t for t in taken if t[1] == [(0, W - 1), (0, H // n - 1)]]
    assert len(shard) == n and all(ok for ok, _b in shard), taken


def test_realize_takes_the_jax_signature():
    x, y = ht.Var("x"), ht.Var("y")
    f = ht.Func("sig")
    f[x, y] = x + 2 * y
    want = np.add.outer(2 * np.arange(3), np.arange(4))
    # positional, in the JAX package's order: sizes, target, dst, jit,
    # device
    np.testing.assert_array_equal(
        ht.Pipeline(f).realize([4, 3], None, None, False, "cpu").to_numpy(),
        want)
    np.testing.assert_array_equal(
        f.realize([4, 3], jit=False, device="cpu").to_numpy(), want)
    # a mesh without a distribute() record is ignored, as in the JAX
    # package
    np.testing.assert_array_equal(
        f.realize([4, 3], device="cpu", mesh=Mesh(["cpu"] * 2, "s"))
        .to_numpy(), want)
    msgs = []
    g = ht.Func("sig_p")
    g[x] = ht.print_expr(x, "sig")
    ht.Pipeline(g).realize([2], None, None, True, "cpu", None,
                           msgs.append)
    assert msgs and "sig" in msgs[0]


def test_mesh_shape_and_slots():
    m = Mesh(np.array([["cpu", "cpu"], ["cpu", "cpu"]], dtype=object),
             ("data", "model"))
    assert m.shape == {"data": 2, "model": 2}
    assert m.axis_devices("model") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 2, ("a", "b"))

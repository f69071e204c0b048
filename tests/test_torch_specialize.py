"""specialize() in both packages: the cases of tests/test_specialize.py,
each built the same way in the port (realized on the CPU) and in the JAX
package, held against numpy and against each other (bit for bit; the
affine case within rtol 1e-6 of numpy). The chosen variant's directives
change the lowering: the tiled branch goes through the stencil-group
kernel's plan (a spy on `group_kernel.try_group`, beside the JAX package's
spy on `pallas_group.try_pallas_group`), the other does not; and they do
not leak past the realize."""
import numpy as np
import pytest

import halide_tpu as hl
import halide_tpu_torch as ht
from halide_tpu.ops import pallas_group as pg
from halide_tpu_torch.ops import group_kernel as gk

from test_torch_basics import _realize


def _make(m, p):
    x, y = m.Var("x"), m.Var("y")
    xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
    rng = np.random.default_rng(0)
    img = rng.standard_normal((64, 128)).astype(np.float32)
    inp = m.Buffer(img)
    f = m.Func("spv")
    f[x, y] = inp[x, y] * 2.0 + 1.0
    f.specialize(p._to_expr() >= 100).tile(x, y, xo, yo, xi, yi, 32, 8)
    return f, img


def _spy(monkeypatch, mod, name):
    """Record, for each call of mod.name, whether it returned a value."""
    engaged = []
    orig = getattr(mod, name)

    def spy(*a, **kw):
        r = orig(*a, **kw)
        engaged.append(r is not None)
        return r
    monkeypatch.setattr(mod, name, spy)
    return engaged


def test_variant_changes_lowering(monkeypatch):
    """p >= 100 -> tiled -> the group kernel's plan takes the group (no
    reject); else untiled, and the plan is never asked."""
    spies = {hl: _spy(monkeypatch, pg, "try_pallas_group"),
             ht: _spy(monkeypatch, gk, "try_group")}
    rejects0 = sum(gk.rejects.values())
    outs = {}
    for m in (hl, ht):
        p = m.Param(m.Int(32), "sp_sel", 0)
        f, img = _make(m, p)
        engaged = spies[m]
        p.set(100)
        tiled = _realize(m, f, [128, 64]).to_numpy()
        np.testing.assert_allclose(tiled, img * 2 + 1, rtol=1e-6)
        assert engaged and engaged[-1], "the tiled variant took no group"
        n_before = len(engaged)
        p.set(0)
        whole = _realize(m, f, [128, 64]).to_numpy()
        np.testing.assert_allclose(whole, img * 2 + 1, rtol=1e-6)
        assert len(engaged) == n_before, "the untiled variant was tiled"
        # the applied directives do not leak outside the realize
        assert not f._defs[0].schedule.splits
        outs[m] = (tiled, whole)
    assert sum(gk.rejects.values()) == rejects0
    for a, b in zip(outs[hl], outs[ht]):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_ladder_order_first_true_wins():
    for m in (hl, ht):
        x = m.Var("x")
        p = m.Param(m.Int(32), "lad_p", 0)
        f = m.Func("lad")
        f[x] = x + p
        a = f.specialize(p._to_expr() > 10)
        b = f.specialize(p._to_expr() > 0)
        a.bound(x, 0, 8)
        b.bound(x, 0, 4)
        p.set(20)   # the first branch: bound 8, so a size-8 realize holds
        out = _realize(m, f, [8]).to_numpy()
        np.testing.assert_array_equal(out, np.arange(8) + 20)
        assert not f._fschedule.bounds     # restored


def test_specialize_fail_raises():
    for m in (hl, ht):
        x = m.Var("x")
        p = m.Param(m.Int(32), "sf_p", 0)
        f = m.Func("sf")
        f[x] = x + p
        f.specialize(p._to_expr() == 1).vectorize(x, 8)
        f.specialize_fail("unsupported parameter value")
        p.set(1)
        np.testing.assert_array_equal(_realize(m, f, [3]).to_numpy(),
                                      [1, 2, 3])
        p.set(2)
        with pytest.raises(m.CompileError, match="unsupported parameter"):
            _realize(m, f, [3])


def test_condition_must_be_static():
    for m in (hl, ht):
        x = m.Var("x")
        f = m.Func("sns")
        f[x] = x
        f.specialize(x > 2).vectorize(x, 4)
        with pytest.raises(m.CompileError, match="statically"):
            _realize(m, f, [4])


def test_plan_cache_keeps_one_plan_per_branch():
    """The plan cache keys on the chosen variant: switching the param back
    and forth reuses each branch's plan and never runs a branch's plan
    under the other's schedule."""
    p = ht.Param(ht.Int(32), "pc_sel", 0)
    f, img = _make(ht, p)
    pipe = ht.Pipeline(f)
    for v in (100, 0, 100, 0):
        p.set(v)
        out = pipe.realize([128, 64], device="cpu").to_numpy()
        np.testing.assert_allclose(out, img * 2 + 1, rtol=1e-6)
    assert len(pipe._plan_cache) == 2
    groups = [bool(run.planned["groups"])
              for run in pipe._plan_cache.values()]
    assert sorted(groups) == [False, True]


def test_condition_on_input_data_is_read_each_realize(monkeypatch):
    """A condition may read an input's values: the variant follows the
    data bound at each realize (the tiled branch where in[0, 0] > 0), where
    a key of shapes alone would keep the first branch's plan."""
    engaged = _spy(monkeypatch, gk, "try_group")
    x, y = ht.Var("x"), ht.Var("y")
    xo, yo, xi, yi = ht.Var("xo"), ht.Var("yo"), ht.Var("xi"), ht.Var("yi")
    inp = ht.ImageParam(ht.Int(32), 2, "cd_in")
    f = ht.Func("cd")
    f[x, y] = inp[x, y] + 1
    f.specialize(inp[0, 0] > 0).tile(x, y, xo, yo, xi, yi, 8, 4)
    pipe = ht.Pipeline(f)
    a = np.arange(64, dtype=np.int32).reshape(8, 8)
    for first, want in ((0, []), (5, [True]), (0, [True])):
        a[0, 0] = first
        inp.set(a)
        out = pipe.realize([8, 8], device="cpu").to_numpy()
        np.testing.assert_array_equal(out, a + 1)
        assert engaged == want

"""The row-histogram kernel (halide_tpu_torch/ops/rowhist_kernel.py, K3) on
the CPU: its plain version against the JAX package's `rowhist_blockdiag`
(Pallas, interpret mode) at the shapes of tests/test_reductions.py (R and P
not block multiples, out-of-range bins that drop, K not a power of two); the
CUDA source built with the host C++ compiler against the plain version, at
the rule's plan, the first design's geometry and every forced plan point
(load units 4, 8 and 16 bytes, 1, 2 and 8 counter copies, clusters of 1, 2
and 4 blocks: the host build runs a cluster's blocks one after another,
then the cluster's merge);
the plan rule; the update path's dispatch to K3; and the wrappers'
routes. The kernel itself runs only on the card (the tests marked
gpu). Counts are integers below 2^24 in f32: every comparison is exact."""
import ctypes
import itertools
import shutil
import subprocess

import numpy as np
import pytest
import torch

import halide_tpu_torch as thl
from halide_tpu_torch.ops import build, rowhist_kernel

SHAPES = [(7, 130, 100), (64, 513, 256), (300, 128, 64)]
# (name, R, P, K, kind, offset, g): a view offset by `offset` elements
# (its base not 16-byte aligned), P not a multiple of any unit, R not a
# multiple of 8 rows, K at 64, 256, 1000 and 1536, the contention inputs
# (one bin a row; runs of equal bins, as a smooth gradient gives) and a
# scale g other than 1
CASES = [("offset", 64, 512, 256, "random", 1, 2.0),
         ("p_ragged", 9, 1001, 1000, "random", 0, 2.0),
         ("k1536", 13, 700, 1536, "random", 0, 2.0),
         ("k64", 40, 96, 64, "random", 3, 1.0),
         ("one_bin", 40, 600, 256, "one_bin", 0, 1.0),
         ("ramp", 40, 600, 256, "ramp", 2, 1.0),
         ("scale", 21, 333, 256, "random", 0, -3.0)]
# every forced point: unit x copies x cluster, at one row a block
# (rows_fast: 4, a 16-byte unit's rows) and 256 threads, so that 8 warps
# count each row
POINTS = [dict(unit=u, copies=c, cluster=cl, threads=256)
          for u, c, cl in itertools.product((4, 8, 16), (1, 2, 8),
                                            (1, 2, 4))]


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


def _contention(R, P, K, kind):
    """The contention inputs, made without randomness: one bin a row
    (lin[r, :] = r % K), or a ramp lin[r, p] = (p K) // P."""
    if kind == "one_bin":
        return np.repeat((np.arange(R) % K)[:, None], P, 1).astype(np.int32)
    return np.repeat(((np.arange(P) * K) // P)[None, :], R, 0).astype(
        np.int32)


def _case_lin(R, P, K, kind, offset, transposed, seed=3, device="cpu"):
    """(R, P) int32 bins on `device`, a view `offset` elements into its
    storage; transposed: neighbouring rows adjacent (rows_fast)."""
    a = _lin(R, P, K, seed) if kind == "random" else _contention(R, P, K,
                                                                 kind)
    flat = torch.zeros(R * P + offset, dtype=torch.int32, device=device)
    if transposed:
        flat[offset:] = torch.from_numpy(np.ascontiguousarray(a.T)).reshape(
            -1).to(device)
        return flat[offset:].view(P, R).t()
    flat[offset:] = torch.from_numpy(a).reshape(-1).to(device)
    return flat[offset:].view(R, P)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel source")
    so = tmp_path_factory.mktemp("rowhist") / "rowhist_kernel.so"
    r = subprocess.run(
        [gxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
         str(so), str(build.CSRC / "rowhist_kernel.cu")],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return rowhist_kernel.bind(ctypes.CDLL(str(so)))


def _forced(lin, point):
    """A forced point at this layout: one row a block, or with rows_fast
    the rows of a 16-byte unit."""
    rows_fast = rowhist_kernel.layout(lin)[0]
    return dict(point, rows=4 if rows_fast else 1)


def _all_points_equal_plain(lib, lin, K, g):
    """The host build at the rule's plan, the first design's geometry and
    every forced point that the layout allows (a unit wider than it allows
    raises before the entry point is called) against the plain version."""
    want = rowhist_kernel.rowhist_plain(lin, K, g)
    max_unit = rowhist_kernel.layout(lin)[1]
    ran = 0
    for point in [None, rowhist_kernel.OLD_DESIGN] + POINTS:
        out = torch.full((lin.shape[0], K), -1.0)
        force = point if point in (None, rowhist_kernel.OLD_DESIGN) \
            else _forced(lin, point)
        if force is not None and force["unit"] > max_unit:
            with pytest.raises(ValueError, match="load unit"):
                rowhist_kernel.call(lib, lin, K, g, out, plan=force)
            continue
        assert rowhist_kernel.call(lib, lin, K, g, out, plan=force) == 0
        plan = rowhist_kernel.last_plan
        assert torch.equal(out, want), plan
        if force is not None:
            assert {k: plan[k] for k in force} == force
        ran += 1
    assert ran == 2 + sum(p["unit"] <= max_unit for p in POINTS)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("R,P,K", SHAPES)
def test_kernel_source_on_host_matches_plain_version(R, P, K, transposed,
                                                     host_lib):
    lin = torch.from_numpy(_lin(R, P, K, seed=3))
    if transposed:          # neighbouring rows adjacent: rows_fast
        lin = lin.t().contiguous().t()
    _all_points_equal_plain(host_lib, lin, K, 2.0)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("name,R,P,K,kind,offset,g", CASES,
                         ids=[c[0] for c in CASES])
def test_kernel_source_on_host_at_edges_and_contention(
        name, R, P, K, kind, offset, g, transposed, host_lib):
    lin = _case_lin(R, P, K, kind, offset, transposed)
    assert lin.data_ptr() % 16 == (4 * offset) % 16
    lay = rowhist_kernel.layout(lin)
    assert lay[0] == transposed
    if not transposed:
        assert rowhist_kernel.head(lay, 16) == (4 - offset % 4) % 4
    _all_points_equal_plain(host_lib, lin, K, g)


def _check_grid(plan, R):
    """The grid: a cluster of blocks for each group of `rows` rows."""
    assert plan["grid"] == -(-R // plan["rows"]) * plan["cluster"], plan


@pytest.mark.parametrize("K", list(range(1, 1537, 97)) + [1024, 1536])
def test_rule_plans_fit_a_block(K):
    """Every planned K in (0, 1536] fits the 227 KB a block can take, in
    both layouts, at hist's rows and at a few rows."""
    for R, P in ((2560, 1536), (7, 130), (64, 262144)):
        for lay in ((False, 16, 0), (True, 16, 0), (False, 4, 4)):
            plan = rowhist_kernel.plan_rowhist(R, P, K, lay)
            assert plan["smem_bytes"] == 4 * plan["rows"] \
                * plan["copies"] * K <= 227 * 1024
            assert plan["resident"] >= 1
            _check_grid(plan, R)


def test_rule_at_hist_and_at_few_long_rows():
    """hist's (2560, 1536) lin gets 16-byte loads, 2 in flight, no
    cluster, and a grid that fills the card in one wave: 2560 blocks of 96
    threads, 21 resident an SM (0.92 waves), so every row is resident at
    once with 1862 of each SM's 2048 thread slots busy on average; a width
    that is not a multiple of 4 gets 4-byte loads, 8 in flight; 64 rows of
    262,144 pixels are split over a cluster of more than one block; K up to
    the counters of one row in 227 KB."""
    plan = rowhist_kernel.plan_rowhist(2560, 1536, 256, (False, 16, 0))
    assert {k: plan[k] for k in ("rows", "threads", "unit", "inflight",
                                 "copies", "cluster", "grid", "resident")} \
        == dict(rows=1, threads=96, unit=16, inflight=2, copies=1,
                cluster=1, grid=2560, resident=21), plan
    threads_sm = plan["grid"] * plan["threads"] / 132
    assert plan["waves"] <= 1 and threads_sm >= 0.9 * 2048, plan
    plan = rowhist_kernel.plan_rowhist(2560, 1535, 256, (False, 4, 0))
    assert (plan["unit"], plan["inflight"]) == (4, 8), plan
    plan = rowhist_kernel.plan_rowhist(64, 262144, 256, (False, 16, 0))
    assert plan["cluster"] > 1, plan
    _check_grid(plan, 64)
    big = rowhist_kernel._MAX_K
    plan = rowhist_kernel.plan_rowhist(3, 100, big, (True, 16, 0))
    assert plan["rows"] == 1 and plan["unit"] == 4
    assert plan["smem_bytes"] <= 227 * 1024


class _NoEntry:
    """A build whose entry point must not be called: the host build's
    kernels and occupancy, its entry point counted."""
    def __init__(self, lib):
        self.calls = 0
        self.rowhist_has = lib.rowhist_has
        self.rowhist_resident = lib.rowhist_resident

    def rowhist(self, *args):
        self.calls += 1
        return 0


@pytest.mark.parametrize("force,K,match", [
    (dict(rows=8, threads=256), 8000, "bytes of counters over"),
    (dict(copies=8, rows=1, threads=256), 8000, "bytes of counters over"),
    (dict(threads=2048), 256, "threads"),
    (dict(threads=96, rows=2), 256, "whole warps"),
    (dict(cluster=16), 256, "cluster size"),
    (dict(copies=9, threads=256, rows=1), 256, "copies"),
    (dict(inflight=3), 256, "in flight"),
    (dict(unit=16, inflight=4), 256, "holds no kernel"),
    (dict(unit=32), 256, "load unit"),
    ({}, rowhist_kernel._MAX_K + 1, "outside")])
def test_plan_over_a_limit_raises_before_the_launch(force, K, match,
                                                   host_lib):
    lib = _NoEntry(host_lib)
    lin = torch.zeros((64, 512), dtype=torch.int32)
    out = torch.empty((64, K), dtype=torch.float32)
    with pytest.raises(ValueError, match=match):
        rowhist_kernel.call(lib, lin, K, 1.0, out, plan=force)
    assert lib.calls == 0


def test_wider_unit_than_the_view_allows_raises(host_lib):
    """A view offset by one element takes 4-byte loads with rows_fast (its
    base is not 16-byte aligned); forcing 16 raises before the launch."""
    lin = _case_lin(16, 64, 32, "random", 1, True)
    assert rowhist_kernel.layout(lin)[:2] == (True, 4)
    lib = _NoEntry(host_lib)
    out = torch.empty((16, 32), dtype=torch.float32)
    with pytest.raises(ValueError, match="load unit"):
        rowhist_kernel.call(lib, lin, 32, 1.0, out,
                            plan=dict(unit=16, rows=4))
    assert lib.calls == 0


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


@pytest.mark.gpu
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("name,R,P,K,kind,offset,g", CASES + [
    ("hist", 2560, 1536, 256, "random", 0, 1.0),
    ("cluster", 64, 262144, 256, "random", 0, 1.0)],
    ids=[c[0] for c in CASES] + ["hist", "cluster"])
def test_plan_points_match_plain_version_on_the_card(
        name, R, P, K, kind, offset, g, transposed):
    """The kernel at the rule's plan, the first design's geometry and every
    forced point against its plain version on the card, at the host tests'
    cases (the views made on the card, so that an offset view's base is
    not 16-byte aligned there either), hist's shape and a shape that plans
    a cluster."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lin = _case_lin(R, P, K, kind, offset, transposed, device="cuda")
    assert lin.data_ptr() % 16 == (4 * offset) % 16
    want = rowhist_kernel.rowhist_plain(lin, K, g)
    max_unit = rowhist_kernel.layout(lin)[1]
    for point in [None, rowhist_kernel.OLD_DESIGN] + POINTS:
        force = point if point in (None, rowhist_kernel.OLD_DESIGN) \
            else _forced(lin, point)
        if force is not None and force["unit"] > max_unit:
            continue
        got = rowhist_kernel.launch(lin, K, g, plan=force)
        torch.cuda.synchronize()
        assert torch.equal(got, want), rowhist_kernel.last_plan
    if name == "cluster" and not transposed:
        rowhist_kernel.launch(lin, K, g)
        assert rowhist_kernel.last_plan["cluster"] > 1

"""The stage kernel (halide_tpu_torch/ops/stage_kernel.py): an untiled
whole-array stage of one pure definition and one value as one emitted CUDA
kernel.

On the CPU: which stages of the benchmark's three apps it takes (all of
their single-definition, single-value stages), the reason of each decline,
the keys and names of the emitted kernels, and their source compiled with
the host C++ compiler against eval_torch's evaluation of the same stage
on the same inputs. On the card (marked gpu): each kernel against
eval_torch on CPU copies of its inputs, and a replayed plan.

Integers compare bit for bit. Floats compare bit for bit where the
operations are the same; a libm function (local_laplacian's exp) may round
the last bit otherwise, and a sum folded in RDom order (resnet_50's
average pool) may round otherwise than torch's tree sum: those are held
to 1e-5 of the stage's largest value, and the largest difference in ULPs
is printed."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import halide_tpu_torch as ht
from halide_tpu_torch.apps import get
from halide_tpu_torch.eval_torch import Ctx, Realized
from halide_tpu_torch.ops import group_kernel as gk
from halide_tpu_torch.ops import stage_kernel as sk
from halide_tpu_torch.pipeline import _evaluate_func

# each cell's app at a small size, and the count of its whole-array
# stages of one pure definition and one value
APPS = {
    "local_laplacian": (dict(width=256, height=128), 38),
    "camera_pipe": (dict(out_width=256, out_height=128, kernel=True,
                         tile=(64, 32)), 4),
    "resnet_50": (dict(batch=1, image=64), 53),
}
FORBIDDEN = ("group_", "scan_segments", "rowhist_blocks")


def _calls(name, device="cpu", seed=3):
    kw, _n = APPS[name]
    app = get(name)(**kw)
    app.bind(app.make_inputs(seed), device)
    app.realize(device)
    return app, sk.stage_calls(app.pipeline, device)


def _host_lib(specs, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the emitted source")
    cu, so = tmp_path / "stages.cpp", tmp_path / "stages.so"
    cu.write_text(sk.translation_unit(specs))
    r = subprocess.run(
        [gxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
         "-ffp-contract=off", "-I", str(gk._CSRC), "-o", str(so), str(cu)],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[:4000]
    return ctypes.CDLL(str(so))


def _ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest distance in units in the last place of `want`'s float
    type between two float tensors."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64,
            torch.float16: torch.int16, torch.bfloat16: torch.int16}
    it = ints[want.dtype]

    def ordered(a):
        i = a.contiguous().view(it).to(torch.int64)
        return torch.where(i < 0, -(i & ~(1 << (a.element_size() * 8 - 1))),
                           i)
    return int((ordered(got) - ordered(want)).abs().max().item()) \
        if want.numel() else 0


def _same(name, got: torch.Tensor, want: torch.Tensor) -> int:
    """Bit for bit where integer; where float, within 1e-5 of the largest
    value. -> the largest ULP distance (0 for integers)."""
    assert got.dtype == want.dtype and got.shape == want.shape, name
    if not want.is_floating_point():
        assert torch.equal(got, want), name
        return 0
    scale = max(want.double().abs().max().item(), 1e-30)
    err = (got.double() - want.double()).abs().max().item()
    assert err <= 1e-5 * scale, (name, err, scale)
    return _ulps(got, want)


@pytest.mark.parametrize("name", sorted(APPS))
def test_every_single_definition_stage_of_each_cell_is_taken(name):
    _app, calls = _calls(name)
    single = [c for c in calls if len(c[0]._defs) == 1
              and len(c[0]._defs[0].values) == 1]
    assert len(single) == APPS[name][1]
    assert [c[0].name for c in single if isinstance(c[3], str)] == []
    # the rest are update definitions (resnet_50's convolutions and fc)
    assert {c[3] for c in calls if c not in single} <= {
        "update definitions"}


@pytest.mark.parametrize("name", sorted(APPS))
def test_host_build_equals_eval_torch(name, tmp_path):
    """Each taken stage's source, built by the host compiler and run on
    the arrays its eval_torch evaluation read, equals that evaluation."""
    _app, calls = _calls(name)
    taken = [c for c in calls if not isinstance(c[3], str)]
    lib = _host_lib([c[3] for c in taken], tmp_path)
    worst = 0
    for f, _box, before, spec, want in taken:
        fn = getattr(lib, f"host_{spec.symbol}")
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        arrays = [before[tid].arrays[vi] for tid, vi in spec.slots]
        out = torch.empty(tuple(reversed(spec.extents)), dtype=want.dtype)
        vals = sk.launch_args(spec, arrays, out)
        assert fn((ctypes.c_longlong * len(vals))(*vals)) == 0
        worst = max(worst, _same(f.name, out, want))
    print(f"{name}: largest ULP distance {worst}")
    if name == "camera_pipe":
        assert worst == 0


def test_u64_host_build_equals_eval_torch(tmp_path):
    """The u64 operations (chip_smoke's `u64_pipeline`: wrapping +, -, *,
    unsigned / and %, min, max, compares, shifts, absd, conversions to and
    from f64 and f32) in the stage kernel's source, against eval_torch:
    f64 -> u64 as XLA converts (NaN and negatives 0, 2^64 and beyond
    2^64 - 1, 2^63 and beyond with the top bit set)."""
    import chip_smoke as cs
    w, h = 16, 8
    rng = np.random.default_rng(7)
    a = rng.integers(0, 2 ** 64 - 1, w * h, endpoint=True, dtype=np.uint64)
    a[:6] = [0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1, 2 ** 63 + 1]
    b = np.roll(a, 3)
    b[::5] = 0
    b[1::6] = 1
    f = rng.uniform(-1e20, 4e19, w * h)
    f[:10] = [np.nan, -1.0, -0.5, 0.5, 2.0 ** 63, 2.0 ** 64, 3e19, np.inf,
              -np.inf, 9.2e18]
    p, golden = cs.u64_pipeline(ht, *(torch.from_numpy(v.reshape(h, w))
                                      for v in (a, b, f)))
    p.realize([w, h, 15], device="cpu")
    (f_, _box, before, spec, want), = sk.stage_calls(p, "cpu")
    lib = _host_lib([spec], tmp_path)
    fn = getattr(lib, f"host_{spec.symbol}")
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    out = torch.empty_like(want)
    vals = sk.launch_args(spec, [before[t].arrays[v] for t, v in spec.slots],
                          out)
    assert fn((ctypes.c_longlong * len(vals))(*vals)) == 0
    for c in range(15):
        assert torch.equal(out[c], want[c]), f"plane {c}"
    gold = golden(a.reshape(h, w), b.reshape(h, w), f.reshape(h, w))
    np.testing.assert_array_equal(out.numpy().view(np.uint64), gold)


def test_pyramid_levels_share_one_source():
    """The downsample's halves of every pyramid level are one source each
    (extents, mins and strides are launch arguments), and their keys hold
    no Func's name."""
    _app, calls = _calls("local_laplacian")
    keys = {c[0].name: c[3].key for c in calls}
    for pyr in ("gPyramid", "inGPyramid"):
        assert len({keys[f"{pyr}_{j}_dy"] for j in range(7)}) == 1, pyr
        assert len({keys[f"{pyr}_{j}"] for j in range(1, 7)}) == 1, pyr
    assert len({keys[f"outGPyramid_{j}"] for j in range(1, 7)}) == 1
    assert len(set(keys.values())) < len(keys) / 3


def test_kernel_names_are_not_the_port_kernels_of_the_profile():
    """`profile.PORT_KERNELS` names K1, K2 and K3 by these substrings: no
    stage kernel's name, nor its parameter type's, holds one."""
    for name in APPS:
        _app, calls = _calls(name)
        for c in calls:
            spec = c[3]
            if isinstance(spec, str):
                continue
            assert spec.symbol == f"stage_{spec.key}"
            glob = [ln for ln in spec.source.splitlines()
                    if "__global__" in ln]
            assert len(glob) == 1
            assert not any(k in spec.symbol or k in glob[0]
                           for k in FORBIDDEN), glob[0]


def test_source_is_deterministic():
    texts = []
    for _ in range(2):
        _app, calls = _calls("local_laplacian", seed=5)
        texts.append(sk.translation_unit(
            [c[3] for c in calls if not isinstance(c[3], str)]))
    assert texts[0] == texts[1]


# ---------------------------------------------------------------------------
# declines: each reason is counted (a stage on a "cuda" Ctx declines before
# anything runs on the card, so these run on the CPU)
# ---------------------------------------------------------------------------

def _one(build, w=16, h=8, params=None):
    """Realize the pipeline `build(x, y, inp)` returns on the CPU; -> (its
    output Func, box, a Ctx on "cuda" over the CPU realizations)."""
    x, y = ht.Var("x"), ht.Var("y")
    inp = ht.ImageParam(ht.Float(32), 2, "inp")
    inp.set(ht.Buffer(torch.arange(w * h, dtype=torch.float32).reshape(
        h, w)))
    out = build(x, y, inp)
    p = ht.Pipeline(out)
    p.realize([w, h], device="cpu")
    calls = sk.stage_calls(p, "cpu")
    f, box, before, _spec, _o = calls[-1]
    vals = {id(k): v for k, v in (params or {}).items()}
    return f, box, Ctx(0, {}, {}, before, vals, torch.device("cuda"))


def _declines(f, box, ctx0, reason):
    n, d = sk.rejects[reason], sk.declined
    assert sk.compute(f, box, ctx0) is None
    assert sk.rejects[reason] == n + 1, dict(sk.rejects)
    assert sk.declined == d + 1


def _update(x, y, inp):
    f = ht.Func("upd")
    f[x, y] = inp[x, y]
    f[x, y] += 1.0
    return f


def _tuple(x, y, inp):
    f = ht.Func("tup")
    f[x, y] = (inp[x, y], inp[x, y] * 2.0)
    return f


def _scheduled(what):
    def build(x, y, inp):
        f = ht.Func("sched")
        f[x, y] = inp[x, y] + 1.0
        if what == "memoize":
            f.memoize()
        elif what == "trace":
            f.trace_stores()
        return f
    return build


def _calling(intrin):
    def build(x, y, inp):
        f = ht.Func("calls")
        if intrin == "print":
            f[x, y] = ht.print_expr(inp[x, y], "value")
        else:
            f[x, y] = inp[x, y] + ht.random_float()
        return f
    return build


@pytest.mark.parametrize("build,reason", [
    (_update, "update definitions"),
    (_tuple, "several values"),
    (_scheduled("memoize"), "memoized"),
    (_scheduled("trace"), "traced"),
])
def test_each_decline_reason_is_counted(build, reason):
    f, box, ctx0 = _one(build)
    _declines(f, box, ctx0, reason)


def test_intrinsics_the_kernel_does_not_take_decline(capsys):
    for intrin, word in (("print", "print"), ("random", "random")):
        f, box, ctx0 = _one(_calling(intrin))
        before = dict(sk.rejects)
        assert sk.compute(f, box, ctx0) is None
        new = [r for r in sk.rejects if sk.rejects[r] != before.get(r, 0)]
        assert len(new) == 1 and word in new[0], new


def test_undef_extern_debug_and_compute_with_decline(tmp_path):
    """Reasons the Func's own definition and schedule give: counted before
    anything is read or emitted."""
    from halide_tpu_torch.bounds import Box, Interval
    x, y = ht.Var("x"), ht.Var("y")
    f = ht.Func("u")
    f[x, y] = ht.undef(ht.Float(32))
    g = ht.Func("dbg")
    g[x, y] = ht.f32(x)
    g.debug_to_file(str(tmp_path / "g.npy"))
    a, b = ht.Func("a"), ht.Func("b")
    a[x, y] = ht.f32(x)
    b[x, y] = ht.f32(y)
    b.compute_with(a, y)
    e = ht.Func("ext")
    e.define_extern("ext", lambda: None, [], ht.Float(32), 2)
    box = Box([Interval(0, 7), Interval(0, 3)])
    ctx0 = Ctx(0, {}, {}, {}, {}, torch.device("cuda"))
    for fn, reason in ((f, "undef"), (g, "debug_to_file"),
                       (b, "a compute_with clique member"),
                       (e, "an extern stage")):
        _declines(fn, box, ctx0, reason)


def test_the_realize_declines_traced_params_shards_and_the_cpu():
    pm = ht.Param(ht.Float(32), "k", 2.0)

    def build(x, y, inp):
        f = ht.Func("scaled")
        f[x, y] = inp[x, y] * pm
        return f
    f, box, ctx0 = _one(build, params={pm: torch.tensor(2.0)})
    _declines(f, box, ctx0, "a traced Param")
    f, box, ctx0 = _one(build, params={pm: 2.0})
    with sk.declining("a sharded realize"):
        _declines(f, box, ctx0, "a sharded realize")
    cpu = Ctx(0, {}, {}, ctx0.realizations, ctx0.params, "cpu")
    n, d = sk.rejects["a CPU tensor"], sk.declined
    assert sk.compute(f, box, cpu) is None
    assert sk.rejects["a CPU tensor"] == n + 1 and sk.declined == d


def test_planned_realizes_plan_the_stages_and_build_none():
    """Under `collecting` a plan's first run on the card plans its stages'
    kernels into the list and builds none; under K1's `planning` alone
    nothing is planned. Either way each stage declines (eval_torch
    computes it)."""
    _app, calls = _calls("camera_pipe")
    for f, box, before, _spec, _o in calls:
        ctx0 = Ctx(0, {}, {}, before, {}, torch.device("cuda"), stages={})
        regions = sk.regions_of(before)
        with sk.collecting() as specs:
            sk.prepare(ctx0, regions, [(f, box, None)])
            _declines(f, box, ctx0, "the stages are planned, not built")
        assert [s.name for s in specs] == [f.name]
        ctx1 = Ctx(0, {}, {}, before, {}, torch.device("cuda"), stages={})
        with gk.planning(lambda *a: None):
            sk.prepare(ctx1, regions, [(f, box, None)])
            _declines(f, box, ctx1, "the groups are planned, not computed")
        assert ctx1.stages == {}


def _conv(op):
    """A stage of inline `op` ("sum" or "max") over a product of two Func
    reads shaped as a convolution, realized on the CPU: -> stage_calls'
    record of it."""
    x, y, c, n = ht.Var("x"), ht.Var("y"), ht.Var("c"), ht.Var("n")
    inp = ht.ImageParam(ht.Float(32), 2, "inp")
    inp.set(ht.Buffer(torch.ones(12, 12)))
    xin = ht.Func("xin")
    xin[c, x, y, n] = inp[x, y] * ht.f32(c + 1)
    xin.compute_root()
    w = ht.Func("w")
    w[c, x, y, n] = ht.f32(c + x + y + n)
    w.compute_root()
    r = ht.RDom(0, 2, 0, 3, 0, 3, "r")
    f = ht.Func(f"conv_{op}")
    val = w[c, r.y, r.z, r.x] * xin[r.x, x + r.y, y + r.z, n]
    f[c, x, y, n] = ht.sum(val) if op == "sum" else ht.maximum(val)
    p = ht.Pipeline(f)
    p.realize([2, 8, 8, 1], device="cpu")
    return sk.stage_calls(p, "cpu")[-1]


def test_an_inline_contraction_stays_with_its_library_path():
    """A sum of two Func reads shaped as a convolution: eval_torch's own
    checks (run on meta tensors) find its convolution path, and the stage
    declines; a maximum over the same RDom is taken."""
    assert _conv("sum")[3] == "an inline sum on the conv path"
    spec = _conv("max")[3]
    assert not isinstance(spec, str), spec


def test_a_probe_error_fails_the_realize_unless_meta_tensors_cause_it(
        monkeypatch):
    """The contraction probe declines a stage on a Contraction and on an
    operation meta tensors cannot run (NotImplementedError, counted by
    its reason); any other error of eval_torch's evaluation propagates
    out of the stage's planning on the card, through `compute` (a stage
    met alone) and `prepare` (a plan's first run), and never sends the
    stage to eval_torch quietly."""
    from halide_tpu_torch import eval_torch as et
    f, box, before, _spec, _o = _conv("sum")

    def raising(kind):
        def eval_array(*_a, **_k):
            raise kind("from the probe")
        return eval_array

    monkeypatch.setattr(et, "eval_array", raising(ValueError))
    cuda = torch.device("cuda")
    with pytest.raises(ValueError, match="from the probe"):
        sk.compute(f, box, Ctx(0, {}, {}, before, {}, cuda))
    with pytest.raises(ValueError, match="from the probe"):
        sk.prepare(Ctx(0, {}, {}, before, {}, cuda, stages={}),
                   sk.regions_of(before), [(f, box, None)])
    monkeypatch.setattr(et, "eval_array", raising(NotImplementedError))
    _declines(f, box, Ctx(0, {}, {}, before, {}, cuda),
              "the contraction probe: an operation with no meta version")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(APPS))
def test_kernels_equal_eval_torch_on_cpu_copies(name):
    """Each fused stage of a realize on the card, made again by the kernel
    on the card's arrays, against `_evaluate_func` on CPU copies of the
    same arrays: the same shape, strides and dtype, equal values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fused = sk.fused
    _app, calls = _calls(name, "cuda")
    assert sk.fused > fused
    worst, n = 0, 0
    for f, box, before, spec, got in calls:
        if isinstance(spec, str):
            continue
        cpu = {tid: Realized(tuple(a.cpu() for a in r.arrays), r.mins,
                             r.name) for tid, r in before.items()}
        want = _evaluate_func(f, box, Ctx(0, {}, {}, cpu, {}, "cpu"))
        want = want.arrays[0]
        assert got.stride() == want.stride(), f.name
        worst = max(worst, _same(f.name, got.cpu(), want))
        n += 1
    assert n == APPS[name][1]
    print(f"{name}: {n} stages, largest ULP distance {worst}")
    if name == "camera_pipe":
        assert worst == 0


@pytest.mark.gpu
def test_replayed_plan_captures_the_stage_kernels():
    """local_laplacian's plan captured as a CUDA graph replays the stage
    kernels (their records in a profile of a replay), and 4 replays equal 4
    eager realizes of the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from halide_tpu_torch import plan_graph
    kw, _n = APPS["local_laplacian"]
    app, eager = get("local_laplacian")(**kw), get("local_laplacian")(**kw)
    inputs = [app.make_inputs(s) for s in range(6)]
    replays = plan_graph.replays
    outs = []
    for data in inputs:
        app.bind(data, "cuda")
        outs.append(app.realize().to_numpy())
    assert plan_graph.replays - replays == 4
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        app.realize()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert any(nm.startswith("stage_") for nm in names), names[:20]
    fused = sk.fused
    for data, got in zip(inputs[2:], outs[2:]):
        eager.pipeline._plan_cache.clear()
        eager.bind(data, "cuda")
        np.testing.assert_array_equal(got, eager.realize().to_numpy())
    assert sk.fused - fused == 4 * APPS["local_laplacian"][1]

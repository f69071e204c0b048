"""Tracing, profiling, memoization, debug_to_file, the print and error
handlers, the loop nest and the report, in both packages: the cases of
tests/test_observability.py, each built the same way in the port (realized
on the CPU) and in the JAX package and held against numpy and against each
other (bit for bit; the exp LUT within rtol 1e-6: the two libms differ by
an ulp). Beyond them: the trace files and the debug_to_file dumps of the two
packages are the same bytes, `loop_nest_str` is the same text, a traced
group anchor (the JAX package records no event for it: a reference fault),
the native runtime's build, and the report's lowering line."""
import contextlib
import io
import os

import numpy as np
import pytest

import halide_tpu as hl
import halide_tpu_torch as ht
from halide_tpu import runtime as jrt
from halide_tpu.ops import pallas_group as pg
from halide_tpu.trace import tracing as jax_tracing
from halide_tpu_torch import pipeline as tp
from halide_tpu_torch import runtime as trt
from halide_tpu_torch.ops import group_kernel as gk
from halide_tpu_torch.trace import tracing as torch_tracing

from test_torch_basics import _realize

TRACING = {hl: jax_tracing, ht: torch_tracing}
RUNTIME = {hl: jrt, ht: trt}


def _pipe(m):
    x, y = m.Var("x"), m.Var("y")
    inp = m.ImageParam(m.Float(32), 2, "t_in")
    p = m.Func("prod")
    c = m.Func("cons")
    p[x, y] = inp[x, y] * 2.0
    p.compute_root().trace_stores().trace_realizations()
    c[x, y] = p[x, y] + 1.0
    return c, inp, p


def _kw(m):
    return {"device": "cpu"} if m is ht else {}


def test_trace_events_and_packets(tmp_path):
    """Per-realization events, and packet files byte for byte equal."""
    files = {}
    for m in (hl, ht):
        c, inp, p = _pipe(m)
        inp.set(np.arange(80, dtype=np.float32).reshape(8, 10))
        pipe = m.Pipeline(c)
        path = str(tmp_path / f"trace_{m.__name__}.bin")
        with TRACING[m](pipe, file=path) as t:
            out = pipe.realize([10, 8], **_kw(m))
            np.asarray(out.to_numpy())
        counts = t.counts()
        assert counts[("begin_realization", "prod")] == 1
        assert counts[("store", "prod")] == 1
        assert counts[("end_realization", "prod")] == 1
        assert ("store", "cons") not in counts
        assert os.path.getsize(path) > 0
        files[m] = open(path, "rb").read()
    assert files[ht] == files[hl]
    # the store packet carries the realized values
    payload = np.arange(80, dtype=np.float32).reshape(8, 10) * 2
    assert payload.tobytes() in files[ht]


def test_profile_report():
    for m in (hl, ht):
        c, inp, p = _pipe(m)
        inp.set(np.ones((8, 10), np.float32))
        rep = m.Pipeline(c).profile([10, 8], **_kw(m))
        names = [e["name"] for e in rep["funcs"]]
        assert "prod" in names and "cons" in names
        assert "ms" in str(rep)
        assert set(rep) == {"total_ms", "funcs"}
        assert set(rep["funcs"][0]) == {"name", "ms", "bytes", "box"}
        assert str(rep).splitlines()[0].startswith(
            "total (stage-at-a-time): ")


def test_memoize_cache_hits():
    outs = {}
    for m in (hl, ht):
        memo_cache = RUNTIME[m].memo_cache
        x = m.Var("x")
        inp = m.ImageParam(m.Float(32), 1, "m_in")
        lut = m.Func("lut_memo")
        lut[x] = m.exp(m.f32(x) * 0.01)
        lut.compute_root().memoize()
        out = m.Func("memo_out")
        out[x] = lut[m.clamp(m.i32(inp[x] * 10.0), 0, 99)]
        inp.set(np.linspace(0, 9.9, 50, dtype=np.float32))
        pipe = m.Pipeline(out)
        memo_cache().clear()
        r1 = pipe.realize([50], **_kw(m)).to_numpy()
        s1 = memo_cache().stats()
        pipe2 = m.Pipeline(out)
        r2 = pipe2.realize([50], **_kw(m)).to_numpy()
        s2 = memo_cache().stats()
        np.testing.assert_allclose(r1, r2)
        assert s2["hits"] > s1["hits"]
        assert (s1["misses"], s1["entries"], s1["bytes"]) == (1, 1, 400)
        outs[m] = (np.asarray(r1), r2, s2)
    np.testing.assert_array_equal(outs[ht][0], outs[ht][1])
    np.testing.assert_allclose(outs[ht][0], outs[hl][0], rtol=1e-6)
    assert outs[ht][2] == outs[hl][2]
    assert tp.last_memo["hits"] == ["lut_memo"]
    assert tp.last_memo["misses"] == []


def test_memo_key_follows_the_inputs():
    """A memoized stage that reads an input: new input values miss, the
    old ones hit again, and each result is the stage over its inputs."""
    x = ht.Var("x")
    inp = ht.ImageParam(ht.Int(32), 1, "mk_in")
    sq = ht.Func("mk_sq")
    sq[x] = inp[x] * inp[x]
    sq.compute_root().memoize()
    out = ht.Func("mk_out")
    out[x] = sq[x] + 1
    trt.memo_cache().clear()
    a = np.arange(6, dtype=np.int32)
    for data, hit in ((a, False), (a + 1, False), (a, True)):
        inp.set(data)
        got = ht.Pipeline(out).realize([6], device="cpu").to_numpy()
        np.testing.assert_array_equal(got, data * data + 1)
        assert tp.last_memo["hits" if hit else "misses"] == ["mk_sq"]


def test_native_runtime_cache():
    for m in (hl, ht):
        c = RUNTIME[m].MemoCache(1 << 20)
        c.store(b"k1", b"hello")
        assert c.lookup(b"k1") == b"hello"
        assert c.lookup(b"nope") is None
        # LRU eviction under pressure
        for i in range(2000):
            c.store(f"key{i}".encode(), b"x" * 1024)
        st = c.stats()
        assert st["bytes"] <= (1 << 20)
        assert st["evictions"] > 0
        c.clear()


def test_native_runtime_is_built_from_the_port_source():
    """The port's runtime is its own copy of the C++ source, built with g++
    into build/ under a host_ key (never a kernel's), and loaded there."""
    from halide_tpu_torch.ops import build
    lib = trt.get_lib()
    assert trt._SRC.read_text().count("ht_cache_lookup") == 1
    key = build.source_key("host_ht_runtime", trt._SRC.read_text())
    assert (build.BUILD_DIR / f"{key}.so").exists()
    assert lib is build._LIBS[key]
    assert not str(trt._SRC).startswith(os.path.dirname(jrt.__file__))


def test_profile_fused_mode():
    for m in (hl, ht):
        c, inp, p = _pipe(m)
        inp.set(np.ones((64, 96), np.float32))
        rep = m.Pipeline(c).profile([96, 64], mode="fused", **_kw(m))
        names = [e["name"] for e in rep["funcs"]]
        assert names == ["prod", "cons"]
        assert rep["total_ms"] >= 0
        # cumulative times are monotone by construction of the deltas
        assert all(e["ms"] >= 0 for e in rep["funcs"])
        cums = [e["cum_ms"] for e in rep["funcs"]]
        assert rep["total_ms"] == cums[-1]
        assert "fused" in str(rep)
        assert set(rep["funcs"][0]) == {"name", "ms", "cum_ms", "box"}


def _dbg_case(m, tmp_path, npy_name, tmp_name):
    x, y = m.Var("x"), m.Var("y")
    f = m.Func("dbg_f")
    g = m.Func("dbg_g")
    f[x, y] = x + y * 10
    g[x, y] = f[x, y] * 2
    f.compute_root()
    npy = str(tmp_path / npy_name)
    f.debug_to_file(npy)
    out = _realize(m, g, [4, 3]).to_numpy()
    f2 = m.Func("dbg_f2")
    g2 = m.Func("dbg_g2")
    f2[x, y] = m.f32(x) + 100.0
    g2[x, y] = f2[x, y] + 1.0
    f2.compute_root()
    tmp = str(tmp_path / tmp_name)
    f2.debug_to_file(tmp)
    assert not os.path.exists(tmp)
    _realize(m, g2, [5, 2])
    return out, npy, tmp


def test_debug_to_file_npy_and_tmp(tmp_path):
    """debug_to_file dumps the realization when produced (reference:
    src/DebugToFile.cpp, Lower.cpp:257): .npy round-trips through numpy;
    other names get the 5-int32-header .tmp layout. The port writes the
    same bytes as the JAX package."""
    files = {}
    for m in (hl, ht):
        out, npy, tmp = _dbg_case(m, tmp_path, f"f_{m.__name__}.npy",
                                  f"f2_{m.__name__}.tmp")
        ref_f = np.arange(4)[None, :] + np.arange(3)[:, None] * 10
        np.testing.assert_array_equal(out, ref_f * 2)
        dumped = np.load(npy)
        np.testing.assert_array_equal(dumped, ref_f.astype(dumped.dtype))
        raw = open(tmp, "rb").read()
        hdr = np.frombuffer(raw[:20], np.int32)
        assert list(hdr[:4]) == [5, 2, 1, 1]
        assert hdr[4] == 0  # float32 type code
        data = np.frombuffer(raw[20:], np.float32).reshape(2, 5)
        np.testing.assert_array_equal(
            data, (np.arange(5)[None, :] + 100.0).repeat(2, axis=0))
        files[m] = (open(npy, "rb").read(), raw)
    assert files[ht] == files[hl]


DUMP_TYPES = ["uint8", "int16", "uint16", "int32", "uint32", "float32",
              "float64", "int64"]


@pytest.mark.parametrize("dtype", DUMP_TYPES)
def test_debug_to_file_bytes_match_per_type(dtype, tmp_path):
    """Each storage type's dump, both formats, a 3-D Func with two values
    (written as name.0 and name.1): the same bytes from both packages."""
    files = {}
    for m in (hl, ht):
        x, y, c = m.Var("x"), m.Var("y"), m.Var("c")
        t = {"uint8": m.UInt(8), "int16": m.Int(16), "uint16": m.UInt(16),
             "int32": m.Int(32), "uint32": m.UInt(32),
             "float32": m.Float(32), "float64": m.Float(64),
             "int64": m.Int(64)}[dtype]
        f = m.Func("dt_f")
        f[x, y, c] = m.Tuple(m.cast(t, x * 7 - y * 3 + c),
                             m.cast(t, x + 100 * c))
        g = m.Func("dt_g")
        g[x, y, c] = f[x, y, c][0] + f[x, y, c][1]
        f.compute_root()
        got = []
        for ext in ("npy", "tmp"):
            path = str(tmp_path / f"{m.__name__}_{dtype}.{ext}")
            f.debug_to_file(path)
            _realize(m, g, [6, 5, 3])
            got.append([open(f"{path}.{i}", "rb").read() for i in (0, 1)])
        files[m] = got
    assert files[ht] == files[hl]


def test_debug_to_file_of_a_group_anchor(tmp_path):
    """A tiled anchor that the group kernel computes is dumped after the
    group, as the JAX package dumps one its Pallas kernel computed; a
    member with a dump keeps its group out of the kernel (the plan's
    reason) and is dumped whole-array."""
    dumps = {}
    for m in (hl, ht):
        x, y = m.Var("x"), m.Var("y")
        xo, yo, xi, yi = (m.Var(n) for n in ("xo", "yo", "xi", "yi"))
        a = np.arange(24 * 16, dtype=np.float32).reshape(16, 24)
        inp = m.Buffer(a)
        p = m.Func("gd_p")
        p[x, y] = inp[x, y] * 2.0
        c = m.Func("gd_c")
        c[x, y] = p[x, y] + p[x + 1, y]
        c.tile(x, y, xo, yo, xi, yi, 8, 4)
        p.compute_at(c, xo)
        path = str(tmp_path / f"anchor_{m.__name__}.npy")
        c.debug_to_file(path)
        out = _realize(m, c, [20, 16]).to_numpy()
        np.testing.assert_array_equal(np.load(path), out)
        dumps[m] = open(path, "rb").read()
        if m is ht:
            assert gk.last_plan["func"] == "gd_c"
            p.debug_to_file(str(tmp_path / "member.npy"))
            gk.last_plan = None
            _realize(m, c, [20, 16])
            assert gk.last_plan is None
            assert gk.rejects_by_name["gd_c"] == "member gd_p: debug_to_file"
            np.testing.assert_array_equal(
                np.load(str(tmp_path / "member.npy")), a[:, :21] * 2)
    assert dumps[ht] == dumps[hl]


def _traced_group(m):
    x, y = m.Var("x"), m.Var("y")
    xo, yo, xi, yi = (m.Var(n) for n in ("xo", "yo", "xi", "yi"))
    a = np.arange(24 * 16, dtype=np.float32).reshape(16, 24)
    p = m.Func("tg_p")
    p[x, y] = m.Buffer(a)[x, y] * 2.0
    c = m.Func("tg_c")
    c[x, y] = p[x, y] + p[x + 1, y]
    c.tile(x, y, xo, yo, xi, yi, 8, 4)
    p.compute_at(c, xo)
    c.trace_stores().trace_realizations()
    p.trace_realizations()
    return c, p, a


def test_trace_of_a_group_anchor_follows_halide():
    """A traced anchor computed by the group kernel records its begin,
    store and end events, as Halide records every realization; its member
    lives in the kernel's shared memory and records none. The JAX package
    records none for the anchor either when its Pallas kernel computed it
    (pipeline.py:866-870 only dumps): a reference fault, so the port is
    held against the rule, not against the JAX package."""
    c, p, a = _traced_group(ht)
    pipe = ht.Pipeline(c)
    gk.last_plan = None
    with torch_tracing(pipe) as t:
        out = pipe.realize([20, 16], device="cpu").to_numpy()
    assert gk.last_plan["func"] == "tg_c"
    assert t.counts() == {("begin_realization", "tg_c"): 1,
                          ("store", "tg_c"): 1,
                          ("end_realization", "tg_c"): 1}
    np.testing.assert_array_equal(out, a[:, :20] * 2 + a[:, 1:21] * 2)


def test_jax_records_no_event_for_a_pallas_anchor(monkeypatch):
    """The reference fault above, shown: the JAX package's Pallas kernel
    takes the traced group and its trace stays empty."""
    engaged = []
    orig = pg.try_pallas_group

    def spy(*args, **kw):
        r = orig(*args, **kw)
        engaged.append(r is not None)
        return r
    monkeypatch.setattr(pg, "try_pallas_group", spy)
    c, p, a = _traced_group(hl)
    pipe = hl.Pipeline(c)
    with jax_tracing(pipe) as t:
        out = np.asarray(pipe.realize([20, 16]).to_numpy())
    assert engaged == [True]
    assert t.counts() == {}
    np.testing.assert_array_equal(out, a[:, :20] * 2 + a[:, 1:21] * 2)


def test_trace_all_target_and_no_pallas(tmp_path):
    """`trace_all` arms every Func's trace flags for the call (and the
    events of a trace installed beside it), `no_pallas` keeps the group
    kernel out, and `profile` prints the profile: as the JAX package
    reads its target, on a CUDA target's spelling."""
    c, p, a = _traced_group(ht)
    c2 = ht.Func("ta_out")
    x, y = ht.Var("x"), ht.Var("y")
    c2[x, y] = c[x, y] * 0.5
    c.compute_root()
    pipe = ht.Pipeline(c2)
    want = (a[:, :20] * 2 + a[:, 1:21] * 2) * 0.5
    gk.last_plan = None
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = pipe.realize([20, 16], device="cpu",
                           target="cuda-sm_90-trace_all-no_pallas-profile")
    np.testing.assert_array_equal(out.to_numpy(), want)
    assert gk.last_plan is None           # no group kernel
    assert buf.getvalue().startswith("total (stage-at-a-time)")
    assert pipe.trace is None
    for f in (c, p, c2):
        assert f._fschedule.trace_stores and f._fschedule.trace_realizations
    with torch_tracing(pipe, file=str(tmp_path / "all.bin")) as t:
        pipe.realize([20, 16], device="cpu")
    assert t.counts() == {(e, n): 1 for n in ("tg_c", "ta_out")
                          for e in ("begin_realization", "store",
                                    "end_realization")}


def test_print_events_under_a_trace():
    """A print inside a traced realize records a print event carrying its
    value (eval_jnp.py:2793-2794), in both packages."""
    evs = {}
    for m in (hl, ht):
        x = m.Var("x")
        f = m.Func("tp_f")
        f[x] = m.print_expr(x * 3, "tripled")
        pipe = m.Pipeline(f)
        msgs = []
        with TRACING[m](pipe) as t:
            pipe.realize([5], custom_print=msgs.append, **_kw(m))
        assert msgs and "tripled" in msgs[0]
        (kind, name, val), = t.events
        assert (kind, name) == ("print", "")
        evs[m] = np.asarray(val)
    np.testing.assert_array_equal(evs[ht], evs[hl])
    np.testing.assert_array_equal(evs[ht], np.arange(5) * 3)


def test_custom_print_handler():
    # hl.print streams through the installed handler once per realization
    # (the JITUserContext::custom_print analog, HalideRuntime.h:178-196)
    for m in (hl, ht):
        msgs = []
        prev = m.set_custom_print(msgs.append)
        try:
            x = m.Var("x")
            f = m.Func("cp_f")
            f[x] = m.print_expr(x * 2, "doubled")
            out = _realize(m, f, [4]).to_numpy()
        finally:
            m.set_custom_print(prev)
        np.testing.assert_array_equal(out, [0, 2, 4, 6])
        assert msgs and "doubled" in msgs[0]
        assert "0, 2, 4, 6" in msgs[0]


def test_per_call_print_handler():
    # realize(custom_print=...) installs the handler for ONE call and
    # restores the previous table on exit (the reference's per-call
    # JITUserContext overrides, Pipeline.cpp:818)
    for m in (hl, ht):
        msgs = []
        x = m.Var("x")
        f = m.Func("pc_f")
        f[x] = m.print_expr(x + 1, "inc")
        p = m.Pipeline(f)
        out = p.realize([4], custom_print=msgs.append, **_kw(m)).to_numpy()
        np.testing.assert_array_equal(out, [1, 2, 3, 4])
        assert msgs and "inc" in msgs[0]
        # the process-level default (stdout) is restored: a second realize
        # must NOT append to msgs
        n = len(msgs)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            p.realize([4], **_kw(m))
        assert len(msgs) == n
        assert "inc" in buf.getvalue()


def test_require_routes_error_handler():
    for m in (hl, ht):
        errs = []
        prev = m.set_error_handler(errs.append)
        try:
            x = m.Var("x")
            p = m.Param(m.Int(32), "rq_p")
            p.set(5)
            f = m.Func("rq_f")
            f[x] = m.require(p > 10, x + p)
            out = _realize(m, f, [3]).to_numpy()
        finally:
            m.set_error_handler(prev)
        np.testing.assert_array_equal(out, [5, 6, 7])
        assert errs and "Requirement Failed" in errs[0]


def test_per_call_error_handler():
    """realize(custom_error=...) routes a failed require for one call."""
    for m in (hl, ht):
        errs = []
        x = m.Var("x")
        p = m.Param(m.Int(32), "pe_p")
        p.set(1)
        f = m.Func("pe_f")
        f[x] = m.require(p > 10, x + p)
        out = m.Pipeline(f).realize([2], custom_error=errs.append,
                                    **_kw(m)).to_numpy()
        np.testing.assert_array_equal(out, [1, 2])
        assert errs and "Requirement Failed" in errs[0]


def _nest_pipeline(m):
    x, y = m.Var("x"), m.Var("y")
    xo, yo, xi, yi = (m.Var(n) for n in ("xo", "yo", "xi", "yi"))
    inp = m.ImageParam(m.UInt(16), 2, "ln_in")
    a = m.Func("ln_a")
    b = m.Func("ln_b")
    h = m.Func("ln_h")
    r = m.RDom(0, 4, "ln_r")
    a[x, y] = inp[x, y] + inp[x + 1, y]
    b[x, y] = a[x, y] + a[x, y + 1]
    h[x] = m.u16(0)
    h[x] += b[x, r.x]
    b.tile(x, y, xo, yo, xi, yi, 16, 8).vectorize(xi).parallel(yo)
    a.compute_at(b, xo)
    b.compute_root()
    h.update().unroll(r.x)
    return h


def test_loop_nest_str_matches_jax():
    """The same text for the same pipeline: a tiled consumer with a
    compute_at producer, vectorized and parallel loops, an update with an
    unrolled RVar."""
    from halide_tpu.loopnest import loop_nest_str as jax_nest
    from halide_tpu_torch.loopnest import loop_nest_str as torch_nest
    texts = [jax_nest(_nest_pipeline(hl)), torch_nest(_nest_pipeline(ht))]
    assert texts[0] == texts[1]
    assert "produce ln_a (at ln_b.xo):" in texts[1]
    assert "  unrolled ln_h.ln_r$x (rvar):\n    for ln_h.x:" in texts[1]
    assert "  parallel ln_b.yo:\n    for ln_b.xo:" in texts[1]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _nest_pipeline(ht).print_loop_nest()
    assert buf.getvalue() == texts[1] + "\n"


def test_report_names_the_group_plan():
    """The report's lowering line names the group kernel's last plan for a
    tiled consumer (sub-tile, threads, shared memory, grid), or the
    reason its plan rejected the schedule."""
    from halide_tpu_torch.report import pipeline_report_html
    c, p, a = _traced_group(ht)
    c.realize([20, 16], device="cpu")
    rec = gk.plans_by_name["tg_c"]
    text = pipeline_report_html(ht.Pipeline(c), [20, 16])
    assert (f"last plan: sub_tile={rec['sub_tile']}, threads="
            f"{rec['threads']}, smem_bytes={rec['smem_bytes']}, "
            f"grid={rec['grid']}") in text
    assert "inferred region: [0, 19], [0, 15]" in text
    p.debug_to_file("/dev/null")
    c.realize([20, 16], device="cpu")
    text = pipeline_report_html(ht.Pipeline(c), [20, 16])
    assert "rejected (member tg_p: debug_to_file)" in text
    assert "last plan" not in text

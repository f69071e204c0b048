"""The port's generator and tools (halide_tpu_torch.generator,
halide_tpu_torch.tools), on the CPU.

The cases of tests/test_tools.py, each through the port's CLI; then the
artifacts across the packages (a .hlpipe the port writes realizes in the
JAX package to the port's output, and the reverse), the object artifact (a
torch.export program naming the port's kernels as custom ops) reloaded in
a fresh process and equal to realize, and tilesearch, fitcost and
`rungen --benchmarks` at small sizes."""
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import halide_tpu_torch as ht
from halide_tpu_torch import generator as G
from halide_tpu_torch.ops import group_kernel as gk
from halide_tpu_torch.tools import gen as gen_cli
from halide_tpu_torch.tools import rungen as rungen_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _blur_ref(img):
    a = img.astype(np.uint16)
    bx = (a[:, :-2] + a[:, 1:-1] + a[:, 2:]) // 3
    return (bx[:-2] + bx[1:-1] + bx[2:]) // 3


# ---------------------------------------------------------------------------
# the cases of tests/test_tools.py, in the port
# ---------------------------------------------------------------------------

def test_gen_emits(tmp_path):
    rc = gen_cli.main(["-g", "blur", "-o", str(tmp_path),
                       "-e", "hlpipe,stmt,metadata,stmt_html",
                       "width=64", "height=48"])
    assert rc == 0
    for f in ("blur.hlpipe", "blur.stmt", "blur.metadata.json",
              "blur.stmt.html"):
        assert (tmp_path / f).exists()
    meta = json.loads((tmp_path / "blur.metadata.json").read_text())
    assert meta["inputs"][0]["name"] == "input"
    # the serialized pipeline reloads and runs
    pipe, images, _ = ht.deserialize_pipeline(
        (tmp_path / "blur.hlpipe").read_text())
    img = np.random.default_rng(0).integers(0, 1 << 14, (48, 64), np.uint16)
    images["input"].set(torch.from_numpy(img))
    out = pipe.realize([62, 46], device="cpu").to_numpy()
    np.testing.assert_array_equal(out, _blur_ref(img))


def test_gen_list(capsys):
    assert gen_cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "blur" in out and "camera_pipe" in out


def test_rungen_describe(capsys):
    rc = rungen_cli.main(["blur", "--describe", "width=64", "height=48"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out)["name"] == "blur"


def test_rungen_run_and_output(tmp_path, capsys):
    out_file = str(tmp_path / "o.npy")
    rc = rungen_cli.main(["blur", "width=64", "height=48", "input=random:7",
                          "--output", out_file, "--parsable_output",
                          "--device", "cpu"])
    assert rc == 0
    arr = np.load(out_file)
    assert arr.shape == (46, 62)
    from halide_tpu_torch.apps import get
    img = get("blur")(width=64, height=48).make_inputs(7)["input"]
    np.testing.assert_array_equal(arr, _blur_ref(img))


def _traced_pipeline(tmp_path, t=None):
    from halide_tpu_torch.trace import tracing
    t = t or ht.Float(32)
    x, y = ht.Var("x"), ht.Var("y")
    inp = ht.ImageParam(t, 2, "tv_in")
    inp.set(torch.ones((12, 16), dtype=ht.htypes.torch_dtype(t)))
    prod = ht.Func("tv_prod")
    cons = ht.Func("tv_cons")
    prod[x, y] = inp[x, y] * 2.0
    prod.compute_root().trace_stores().trace_realizations()
    cons[x, y] = prod[x, y] + 1.0
    pipe = ht.Pipeline(cons)
    path = str(tmp_path / "trace.bin")
    with tracing(pipe, file=path):
        pipe.realize([16, 12], device="cpu").to_numpy()
    return path


def test_traceviz_dump_and_html(tmp_path, capsys):
    # reference: util/HalideTraceViz.cpp / HalideTraceDump.cpp
    from halide_tpu_torch.tools import traceviz
    path = _traced_pipeline(tmp_path)
    packets = traceviz.read_packets(path)
    assert any(p.event == 1 and p.name == "tv_prod" for p in packets)
    stores = [p for p in packets if p.event == 1]
    arr = traceviz.decode_store(stores[0])
    assert arr is not None and arr.shape == (12, 16)
    np.testing.assert_allclose(arr[0, 0], 2.0)
    assert traceviz.main([path, "--dump"]) == 0
    out = capsys.readouterr().out
    assert "tv_prod" in out and "total packets" in out
    html_path = str(tmp_path / "t.html")
    assert traceviz.main([path, "-o", html_path]) == 0
    html = open(html_path).read()
    assert "tv_prod" in html and "data:image/png;base64," in html


def test_gen_emit_pysource(tmp_path):
    # the CodeGen_C analog: -e pysource writes a standalone runnable .py
    # (graph round trip + the lowered program) that reproduces the output
    gen = G.create("blur")
    written = G.emit_artifacts(gen, str(tmp_path), "blur_fn", ["pysource"],
                               sizes=None)
    assert "pysource" in written, written
    ns = {}
    exec(open(written["pysource"]).read(), ns)
    img = np.random.default_rng(0).integers(0, 1 << 14, (34, 66), np.uint16)
    out = ns["run"]([64, 32], device="cpu",
                    input=torch.from_numpy(img)).to_numpy()
    np.testing.assert_array_equal(out, _blur_ref(img))


# ---------------------------------------------------------------------------
# beyond the JAX cases
# ---------------------------------------------------------------------------

def test_traceviz_decodes_bfloat16(tmp_path):
    """The port's writer codes a bfloat16 store as type 3, its payload
    widened to f32 (numpy has no bfloat16)."""
    from halide_tpu_torch.tools import traceviz
    path = _traced_pipeline(tmp_path, ht.BFloat(16))
    store = [p for p in traceviz.read_packets(path) if p.event == 1][0]
    assert store.dtype_code == 3 | (16 << 8)
    np.testing.assert_array_equal(traceviz.decode_store(store),
                                  np.full((12, 16), 2.0, np.float32))


def test_pysource_appends_the_lowered_program(tmp_path):
    """With sizes, pysource's appendix is the port's lowered program: each
    stage's lowering as the report names it, each group's plan and its
    emitted K1 source."""
    gen = G.create("blur", width=96, height=64, tile=(32, 16))
    written = G.emit_artifacts(gen, str(tmp_path), "b", ["pysource"],
                               sizes=[94, 62], device="cpu")
    src = open(written["pysource"]).read()
    assert "# ---- lowered program ----" in src
    assert "# blur_y: group kernel: tile ('x', 32, 'y', 16)" in src
    assert "# group blur_y: {'func': 'blur_y'" in src
    assert '# extern "C" int launch_' in src


@pytest.mark.parametrize("name", ["blur", "iir_blur"])
def test_hlpipe_across_packages(name, tmp_path):
    """A .hlpipe the port's gen writes realizes in the JAX package to the
    port's output, and the JAX package's in the port to the JAX output.
    (The JAX package is imported here: the machine with the card has
    none, and the gpu tests import none.)"""
    import halide_tpu as hl
    from halide_tpu.apps import get as jax_get
    from halide_tpu.tools import gen as jax_gen
    from halide_tpu_torch.apps import get as torch_get
    from test_torch_apps import _compare
    kw = dict(width=64, height=48)
    assert gen_cli.main(["-g", name, "-o", str(tmp_path / "t"), "-e",
                         "hlpipe"] + [f"{k}={v}" for k, v in kw.items()]) == 0
    assert jax_gen.main(["-g", name, "-o", str(tmp_path / "j"), "-e",
                         "hlpipe"] + [f"{k}={v}" for k, v in kw.items()]) == 0
    tapp, japp = torch_get(name)(**kw), jax_get(name)(**kw)
    data = tapp.make_inputs(0)
    tapp.bind(data, "cpu")
    japp.bind(data)
    t_out = tapp.realize("cpu").to_numpy()
    j_out = np.asarray(japp.realize().to_numpy())
    sizes = tapp.output_sizes
    pj, imj, _ = hl.deserialize_pipeline(
        (tmp_path / "t" / f"{name}.hlpipe").read_text())
    pt, imt, _ = ht.deserialize_pipeline(
        (tmp_path / "j" / f"{name}.hlpipe").read_text())
    for k, v in data.items():
        imj[k].set(v)
        imt[k].set(torch.from_numpy(v))
    _compare(tapp, np.asarray(pj.realize(sizes).to_numpy()), t_out)
    _compare(tapp, pt.realize(sizes, device="cpu").to_numpy(), j_out)


_LOAD = """
import sys, numpy as np, torch
from halide_tpu_torch import generator as G
fn = G.load_compiled(open(sys.argv[1], "rb").read())
args = [torch.from_numpy(np.load(p)) for p in sys.argv[3:]]
np.save(sys.argv[2], fn(*args)[0].numpy())
"""


@pytest.mark.parametrize("name,kw,op", [
    ("blur", dict(width=96, height=64, tile=(32, 16)), "group"),
    ("hist", dict(width=256, height=512), "rowhist"),
    ("iir_blur", dict(width=96, height=64), "scan")])
def test_object_reloads_in_a_fresh_process(name, kw, op, tmp_path):
    """gen -e object: a torch.export program whose graph names the port's
    kernel as a custom op; loaded in a fresh process (which plans the
    groups again from the artifact's text), it equals realize on the CPU
    (the plain versions: bit for bit)."""
    import zipfile
    from halide_tpu_torch.apps import get
    app = get(name)(**kw)
    sizes = app.output_sizes
    assert gen_cli.main(
        ["-g", name, "-o", str(tmp_path), "-e", "object", "--sizes",
         "x".join(map(str, sizes)), "--device", "cpu"]
        + [f"{k}={','.join(map(str, v)) if k == 'tile' else v}"
           for k, v in kw.items()]) == 0
    path = tmp_path / f"{name}.exported"
    with zipfile.ZipFile(path) as z:
        prog = z.read("program.pt2")
        meta = json.loads(z.read("meta.json"))
    graph = torch.export.load(io.BytesIO(prog)).graph
    calls = {str(n.target) for n in graph.nodes if n.op == "call_function"}
    assert f"halide_tpu_torch.{op}.default" in calls, calls
    assert (op == "group") == bool(meta["kernels"])
    data = app.make_inputs(0)
    app.bind(data, "cpu")
    want = app.realize("cpu").to_numpy()
    ins = []
    for k, spec in enumerate(app.inputs):
        np.save(tmp_path / f"in{k}.npy", data[spec.name])
        ins.append(str(tmp_path / f"in{k}.npy"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", _LOAD, str(path),
                    str(tmp_path / "out.npy")] + ins, check=True, env=env,
                   timeout=300)
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want)


def test_export_refuses_what_a_program_cannot_hold():
    """An extern stage (a host callback) cannot be exported."""
    x, y = ht.Var("x"), ht.Var("y")
    src = ht.Func("src")
    src[x, y] = ht.f32(x + y)
    ext = ht.Func("ext")
    ext.define_extern("ext", lambda a: a * 2, [src], ht.Float(32), 2)
    with pytest.raises(ht.CompileError, match="cannot export ext"):
        G.export_compiled(ht.Pipeline(ext), [8, 8], "cpu")


def test_tilesearch_on_the_cpu(capsys):
    from halide_tpu_torch.tools import tilesearch
    rows = tilesearch.search("blur", [(32, 16), (64, 32)], (96, 64), "cpu")
    assert sorted(r[1] for r in rows) == ["32x16", "64x32", "auto"]
    out = capsys.readouterr().out
    assert "winner:" in out and "'sub_tile'" in out
    assert {r[2]["tile"] for r in rows if r[1] != "auto"} == {(32, 16),
                                                              (64, 32)}


def test_fitcost_on_the_cpu(capsys):
    from halide_tpu_torch.tools import fitcost
    assert fitcost.main(["--device", "cpu", "--size", "64x32",
                         "--mb", "1"]) == 0
    out = capsys.readouterr().out
    assert "FITCOST cpu ops_per_byte=" in out
    assert '"cpu": {"ops_per_byte":' in out


def test_rungen_benchmark_on_the_cpu(capsys):
    assert rungen_cli.main(["iir_blur", "width=64", "height=48",
                            "--benchmarks=all", "--parsable_output",
                            "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["name"] == "iir_blur" and rec["device"] == "cpu"
    assert rec["ms"] > 0


def test_tools_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is attached")
    with pytest.raises(RuntimeError, match="CUDA"):
        rungen_cli.main(["blur", "width=64", "height=48"])


@pytest.mark.gpu
def test_object_on_the_card(tmp_path):
    """The exported blur launches K1 through its op on the card and equals
    realize bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from halide_tpu_torch.apps import get
    app = get("blur")(width=2560, height=1536, tile=(256, 128))
    app.bind(app.make_inputs(0))
    blob = G.export_compiled(app.pipeline, app.output_sizes)
    fn = G.load_compiled(blob)
    want = app.realize().to_numpy()
    launches = gk.launches
    got = fn(app.inputs[0].get().data)[0]
    assert gk.launches == launches + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)

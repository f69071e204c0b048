"""resnet_50 as the benchmark runs it, on the CPU at small sizes: the
configuration that `bench_h100/tools/resnet_config.py` writes, run through
`bench_h100.run.run_cell` against the plain reference
(`bench_h100/reference/resnet_50.py`) on weights drawn from the
configuration's input kinds; the reference alone at the published widths;
the float comparison; the port's contract.* counters and `ht.contract`
spans; the kernel classifier; and the frozen contraction work against the
app's own count."""
import json
import math
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import halide_tpu_torch as ht
from halide_tpu_torch import spans
from halide_tpu_torch.apps import get
from halide_tpu_torch.apps.resnet_50 import _resnet_flops
from halide_tpu_torch.models import nn as tnn
from halide_tpu_torch.models import resnet50 as rn

from bench_h100 import frames, kernels, run
from bench_h100.spec import HERE, Cell, load_json, load_module
from bench_h100.tools import count_resnet, resnet_config

ROOT = HERE.parent
SMALL = dict(width=8, classes=10)
SEED = 2 ** 31 + 77


def _cell(layers, monkeypatch, image=32, batch=2):
    monkeypatch.setattr(frames, "RING_MIN_BYTES", 10_000)
    cfg = resnet_config.config(layers, sizes={"small": [image, batch]},
                               **SMALL)
    return Cell("resnet_50.small", 1, cfg, {"size": "small",
                                            "check_frames": 2},
                [image, batch], {}, {})


def _units():
    b = load_json(ROOT / "BENCHMARK.json")
    return {m["name"]: m["unit"] for m in b["end_to_end"] + b["per_layer"]}


def _perturb(name, index):
    """A `wrap` for run_cell: the program realizes with one element of the
    fixed input `name` moved by 0.5; the reference sees it unmoved."""
    def wrap(stream):
        w = stream.inputs.fixed[name].clone()
        w.view(-1)[index] += 0.5

        def realize(sizes, device):
            stream.params[name].set(w)
            return stream.app.pipeline.realize(sizes, device=device)
        return realize
    return wrap


@pytest.mark.parametrize("layers", [(1, 1, 1, 1), (3, 4, 6, 3)])
def test_the_port_against_the_reference_through_run_cell(layers,
                                                         monkeypatch):
    torch.set_num_threads(1)
    cell = _cell(layers, monkeypatch)
    out = run.run_cell(cell, SEED, 0.2, False, "cpu", time.perf_counter(),
                       _units())
    assert out["result"]["correct"] is True
    (name, value, limit), = out["checks"]
    assert name == "max_rel_err" and value <= limit
    # one weight moved: the stream's outputs no longer match
    out = run.run_cell(cell, SEED, 0.1, False, "cpu", time.perf_counter(),
                       _units(), wrap=_perturb("res0_0_c_b", 0))
    assert out["result"]["correct"] is False
    assert out["result"]["failed"] >= 1


@pytest.mark.parametrize("layers", [(1, 1, 1, 1), (3, 4, 6, 3)])
def test_the_reference_is_the_apps_numpy_golden(layers):
    torch.set_num_threads(1)
    p = rn.ResNetParams(layers, 8, 10, 32, 2)
    data = rn.random_weights(p, 3)
    ref = load_module(HERE / "reference" / "resnet_50.py")
    mine = ref.reference({k: torch.from_numpy(v) for k, v in data.items()},
                         {"layers": list(layers), **SMALL})
    assert mine.dtype == torch.float32
    np.testing.assert_allclose(mine.numpy(), rn.reference(p, data),
                               rtol=1e-4, atol=1e-6)


def test_the_reference_restores_the_tf32_flags():
    torch.set_num_threads(1)
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, dnn.allow_tf32)
    seen = []
    ref = load_module(HERE / "reference" / "resnet_50.py")
    real = ref._forward

    def spy(*args):
        seen.append((mm.allow_tf32, dnn.allow_tf32))
        return real(*args)
    try:
        mm.allow_tf32 = dnn.allow_tf32 = True
        ref._forward = spy
        p = rn.ResNetParams((1, 1, 1, 1), 8, 10, 32, 1)
        data = rn.random_weights(p, 1)
        ref.reference({k: torch.from_numpy(v) for k, v in data.items()},
                      {"layers": [1, 1, 1, 1], **SMALL})
        assert seen == [(False, False)]
        assert (mm.allow_tf32, dnn.allow_tf32) == (True, True)
    finally:
        mm.allow_tf32, dnn.allow_tf32 = saved


def test_the_lower_precision_control_is_not_correct(monkeypatch):
    torch.set_num_threads(1)
    cell = _cell((3, 4, 6, 3), monkeypatch)
    inputs = frames.make_inputs(cell, 5, "cpu", frames=1)
    ref, cmp = cell.reference(), cell.compare()
    want = ref.reference(inputs.frame(0), cell.config["args"])
    got = ref.reference(inputs.frame(0), cell.config["args"],
                        torch.bfloat16)
    limits = cell.config["check"]["limits"]
    nums = cmp.numbers(got, want, cell.config["check"])
    assert any(v > limits[k] for k, v in nums.items())


def test_the_published_network_keeps_its_softmax_informative():
    """The configuration's weights at the published widths (batch 2 on the
    CPU): the logits spread by 1-4 across the 1000 classes and no row's
    largest probability reaches 0.9, where the app's own random weights
    give logits of 100-400 and a one-hot softmax."""
    torch.set_num_threads(4)
    cfg = resnet_config.config()
    cell = Cell("resnet_50.b2", 1, cfg, {"size": "b2"}, [224, 2], {})
    inputs = frames.make_inputs(cell, SEED, "cpu", frames=1)
    ref = cell.reference()
    data = inputs.frame(0)
    probs = ref.reference(data, cfg["args"])
    assert probs.shape == (2, 1000)
    assert float(probs.max(dim=1).values.max()) < 0.9
    logits = probs.log()
    std = logits.std(dim=1)
    assert bool(((std > 1) & (std < 4)).all()), std
    # the two images' rows differ by more than any rounding would
    assert float((probs[0] - probs[1]).abs().max() / probs.max()) > 1e-2


def test_the_reference_imports_nothing_of_the_program():
    code = ("from bench_h100.spec import HERE, load_module\n"
            "load_module(HERE / 'reference' / 'resnet_50.py')\n"
            "import sys, json\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    loaded = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "halide_tpu",
                         "halide_tpu_torch"}


def test_the_relative_comparison_on_a_hand_made_case():
    cmp = load_module(HERE / "compare" / "relative.py")
    want = torch.tensor([[0.5, 0.25], [0.125, 0.125]])
    got = want.clone()
    assert cmp.numbers(got, want, {}) == {"max_rel_err": 0.0}
    got[1, 0] += 0.001
    (v,) = cmp.numbers(got, want, {}).values()
    assert v == pytest.approx(0.002, rel=1e-4)
    got[0, 1] = float("nan")
    assert cmp.numbers(got, want, {}) == {"max_rel_err": math.inf}
    with pytest.raises(ValueError):
        cmp.numbers(got.double(), want, {})
    with pytest.raises(ValueError):
        cmp.numbers(got[:1], want, {})


def test_the_normal_input_kind_draws_from_the_seed():
    kind = load_module(HERE / "inputs" / "normal.py")
    spec = {"name": "w", "dtype": "float32", "mean": 0.5, "std": 2.0}

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return kind.make(spec, [64, 512], g, "cpu")
    a, b, c = draw(7), draw(7), draw(8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.float32
    assert float(a.mean()) == pytest.approx(0.5, abs=0.05)
    assert float(a.std()) == pytest.approx(2.0, rel=0.02)
    zero = kind.make({**spec, "std": 0.0}, [3], torch.Generator(), "cpu")
    assert zero.tolist() == [0.5, 0.5, 0.5]


def test_the_configuration_is_the_generators_at_the_published_widths():
    on_disk = load_json(HERE / "configs" / "resnet_50.json")
    made = resnet_config.config()
    for k in ("work", "work_method", "work_card"):
        on_disk.pop(k, None)
    assert on_disk == made
    assert made["reduced"] == []
    assert made["args"] == {"layers": [3, 4, 6, 3], "width": 64,
                            "classes": 1000}
    assert len(made["inputs"]) == 1 + 4 * 53 + 2
    # every input of the app, and no other
    app = get("resnet_50")(image=32, batch=1)
    assert [s["name"] for s in made["inputs"]] == \
        [p.name for p in app.inputs]


def test_the_contraction_work_is_the_apps_flop_count(monkeypatch):
    layers, width, classes, image, batch = (3, 4, 6, 3), 64, 1000, 224, 128
    work = count_resnet.contract_work(layers, width, classes, image, batch)
    assert work["f32_ops"] == _resnet_flops(
        rn.ResNetParams(layers, width, classes, image, batch))
    assert work["contractions"] == 54
    on_disk = load_json(HERE / "configs" / "resnet_50.json")
    if "work" in on_disk:
        assert on_disk["work"]["batch128"]["contract"] == work
    # the frame's count at a small size: every stage's operations, the
    # convolutions' among them
    torch.set_num_threads(1)
    cell = _cell((3, 4, 6, 3), monkeypatch)
    counted = count_resnet.count(cell, "cpu")
    small = rn.ResNetParams((3, 4, 6, 3), 8, 10, 32, 2)
    assert counted["contract"]["f32_ops"] == _resnet_flops(small)
    assert counted["frame"]["f32_ops"] > counted["contract"]["f32_ops"]


def _counts():
    c = spans.counters()
    return {k: c[k] for k in ("contract.conv", "contract.einsum",
                              "contract.unrolled", "contract.dense")}


def test_contract_counters_and_spans_on_an_eager_realize():
    """Every conv2d of the small network is counted under contract.conv,
    with one `ht.contract` span inside its stage's `ht.stage`; fc is dense
    at this size (under `eval_torch._EINSUM_MIN_FULL`)."""
    torch.set_num_threads(1)
    app = get("resnet_50")(layers=(1, 1, 1, 1), image=32, batch=2, **SMALL)
    app.bind(app.make_inputs(0), "cpu")
    before = _counts()
    app.realize("cpu")
    after = _counts()
    delta = {k: after[k] - before[k] for k in after}
    assert delta == {"contract.conv": 1 + 4 * 4, "contract.einsum": 0,
                     "contract.unrolled": 0, "contract.dense": 1}
    rec = spans.recent()[-1]["spans"]
    assert spans.KINDS[spans.CONTRACT] == "ht.contract"
    assert rec["ht.contract"]["count"] == 17
    assert 0 < rec["ht.contract"]["total_ns"] <= rec["ht.stage"]["total_ns"]
    # a hit on the CPU runs eager again, and counts again
    app.realize("cpu")
    assert _counts()["contract.conv"] == after["contract.conv"] + 17


def test_fc_at_the_cells_size_takes_the_einsum_path():
    """fc as the cell runs it: 2048 features to 1000 classes over a batch
    of 128, one einsum, one `ht.contract` span."""
    torch.set_num_threads(4)
    rng = np.random.default_rng(3)
    c, n = ht.Var("c"), ht.Var("n")
    feat = rng.standard_normal((128, 2048), np.float32)
    pooled = ht.Func("pooled128")
    pooled[c, n] = ht.Buffer(feat)[c, n]
    pooled.compute_root()
    w = rng.standard_normal((2048, 1000), np.float32) * np.float32(0.01)
    fcw = ht.ImageParam(ht.Float(32), 2, "fc_w")
    fcb = ht.ImageParam(ht.Float(32), 1, "fc_b")
    fcw.set(w)
    fcb.set(np.zeros(1000, np.float32))
    fc = tnn.dense("fc128", pooled, fcw, fcb, 2048)
    before = _counts()
    got = fc.realize([1000, 128], device="cpu").to_numpy()
    after = _counts()
    assert after["contract.einsum"] - before["contract.einsum"] == 1
    assert after["contract.dense"] == before["contract.dense"]
    assert spans.recent()[-1]["spans"]["ht.contract"]["count"] == 1
    np.testing.assert_allclose(got, feat @ w, rtol=1e-4, atol=1e-4)


CLASSES = [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul>)", "native"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, "
     "float, 4> >(at::native::ReduceOp<float, at::native::MeanOps<float, "
     "float, float, float>, unsigned int, float, 4>)", "native"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("Memset (Device)", "copy"),
    ("group_5bdd44a684bd0b3e", "port"),
    ("scan_segments", "port"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x32_warpgroupsize1x1x1_execute_segment_k_off_kernel"
     "__5x_cudnn", "library"),
    ("void cudnn::ops::nchwToNhwcKernel<float, float, float, false, true, "
     "(cudnnKernelDataType_t)2>(cudnn::ops::nchw2nhwc_params_t<float>, "
     "float const*, float*)", "library"),
    ("ampere_sgemm_128x64_tn", "library"),
]


@pytest.mark.parametrize("name,want", CLASSES + [
    (n, k) for n, k in kernels.RECORDED])
def test_the_kernel_classifier(name, want):
    assert kernels.kind(name) == want
    assert kernels.is_library(name) == (want == "library")


def test_the_new_metrics_read_nothing_without_a_profile():
    """On a port or a run without what they read (the parent's untraced
    runs, a CPU run) the readers give None and do not raise."""
    rec = {"profile": None, "work": {}, "spans": [], "frame_ms": 1.0}
    for name in ("contract.device_ms", "contract_roofline",
                 "glue.device_ms"):
        assert load_module(HERE / "metrics" / f"{name}.py").read(rec) is None
    share = load_module(HERE / "metrics" / "contract.library_share.py")
    v = share.read(rec)
    assert v is None or 0 <= v <= 100


def test_the_new_metrics_split_a_profile():
    from bench_h100.profile import Profile
    ks = [(n, 0.0, 10.0 * (i + 1)) for i, (n, _k) in enumerate(CLASSES)]
    p = Profile(2, 1000.0, ks, [], 0, 0)
    lib = sum(e for (n, k), (_n, _s, e) in zip(CLASSES, ks)
              if k == "library")
    other = sum(e for _n, _s, e in ks) - lib
    rec = {"profile": p, "work": {"contract": {
        "bytes": 0, "f32_ops": 67e12 * 1e-6, "int_ops": 0}}}
    dev = load_module(HERE / "metrics" / "contract.device_ms.py").read(rec)
    glue = load_module(HERE / "metrics" / "glue.device_ms.py").read(rec)
    roof = load_module(HERE / "metrics" / "contract_roofline.py").read(rec)
    assert dev == pytest.approx(lib * 1e-3 / 2)
    assert glue == pytest.approx(other * 1e-3 / 2)
    # 1 us of least time over lib / 2 us a frame
    assert roof == pytest.approx(100.0 * 1.0 / (lib / 2))


def test_the_cell_is_declared_on_one_chip():
    b = load_json(ROOT / "BENCHMARK.json")
    (w,) = [w for w in b["workloads"] if w["name"] == "resnet_50.batch128"]
    assert (w["config"], w["traffic"], w["chips"]) == ("resnet_50",
                                                       "batch128", 1)
    traffic = load_json(HERE / "traffic" / "batch128.json")
    assert traffic == {"size": "batch128", "check_frames": 2}
    new = {"contract.device_ms", "contract_roofline", "glue.device_ms",
           "contract.library_share"}
    for m in b["per_layer"]:
        if m["name"] in new:
            assert m["workloads"] == ["resnet_50.batch128"]
        elif "workloads" in m:
            assert "resnet_50.batch128" not in m["workloads"]
    for name in new:
        assert (HERE / "metrics" / f"{name}.py").is_file()
    # the ring: two batches of 77 MB, past 1.5 times the L2
    cell_bytes = 128 * 224 * 224 * 3 * 4
    assert frames.ring_length(cell_bytes) == 2

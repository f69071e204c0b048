"""The granite_4_h_micro cell's parts found by name, its ring of two
prompts, its readers' answers without records, its frozen work against
`count_granite.py`, and at a small size on the CPU a run (correct, and
not correct where every frame gives the first one's logits) and its
readings: the program within the configuration's limit, the
lower-precision control past it."""
import math
import subprocess
import sys
import time

import pytest
import torch

from bench_h100 import frames, run
from bench_h100.run import ROOT
from bench_h100.spec import find_cell, load_json
from bench_h100.test_h100_faults import stale
from bench_h100.tools import count_granite, granite_config, readings

CELL = "granite_4_h_micro.prefill4k"
METRICS = ("scan.device_ms", "scan_roofline", "gemm_roofline")
# the tests' model: a small size with every kind of layer
SMALL = dict(granite_config.PUBLISHED, hidden_size=64, vocab_size=512,
             layer_types=["mamba", "mamba", "attention", "mamba"],
             mamba_n_heads=4, mamba_d_head=16, mamba_expand=1,
             mamba_d_state=16, mamba_chunk_size=16, num_attention_heads=4,
             num_key_value_heads=2, shared_intermediate_size=128)


def _cell():
    return find_cell(load_json(ROOT / "BENCHMARK.json"), CELL)


def test_the_cell_and_its_metrics_are_found_by_name():
    cell = _cell()
    assert cell.size == [4096, 1] and cell.chips == 1
    assert set(METRICS) <= set(cell.metrics)
    assert {"pipeline.host_ms", "frame_mfu", "device.idle_share",
            "setup.port_s", "stage_kernel.share"} <= set(cell.metrics)
    assert "contract_roofline" not in cell.metrics
    assert cell.compare().__name__.endswith("relative")
    for name in cell.metrics:
        assert callable(cell.reader(name).read)
    assert set(cell.work) == {"frame", "contract", "scan"}
    assert cell.config["reduced"] == []
    # every key of the published config.json, as published
    for k, v in granite_config.PUBLISHED.items():
        assert cell.config[k] == v, k


@pytest.mark.parametrize("name", METRICS)
def test_each_reader_returns_none_without_records(name):
    cell = _cell()
    reader = cell.reader(name)
    assert reader.read({"profile": None, "work": cell.work}) is None

    class Empty:
        frames, kernels = 10, []
    assert reader.read({"profile": Empty(), "work": cell.work}) is None
    assert reader.read({"profile": Empty(), "work": {}}) is None


def test_readers_count_their_kernels_only():
    cell = _cell()

    class Traced:
        frames = 2
        kernels = [("void scan_segments<16, false, false>(ScanArgs)", 0, 10),
                   ("stage_0123456789abcdef", 10, 30),
                   ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x64"
                    "x8_stage3_warpsize2x2x1_ffma_execute_kernel__5x_cublas",
                    30, 130),
                   ("void at::native::elementwise_kernel<128, 2>(int)",
                    130, 150)]
    rec = {"profile": Traced(), "work": cell.work}
    assert cell.reader("scan.device_ms").read(rec) == pytest.approx(5e-3)
    gemm = cell.reader("gemm_roofline")
    assert gemm.is_gemm(Traced.kernels[2][0])
    assert not gemm.is_gemm(Traced.kernels[1][0])
    assert not gemm.is_gemm(Traced.kernels[0][0])
    from bench_h100 import stats
    least, _b = stats.least_time_s(cell.work["contract"])
    assert gemm.read(rec) == pytest.approx(100 * least / 50e-6)


def test_the_reference_imports_no_jax_and_no_port_kernel():
    code = ("from bench_h100.spec import HERE, load_module\n"
            "load_module(HERE / 'reference' / 'granite_4_h_micro.py')\n"
            "import sys\nprint(sorted({m.split('.')[0] for m in "
            "sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    loaded = set(eval(r.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "halide_tpu", "halide_tpu_torch"}


def test_count_granite_reproduces_the_configurations_work():
    cell = _cell()
    assert count_granite.count(cell) == cell.work
    work = cell.work
    assert work["scan"]["launches"] == 36
    # the frame holds every contraction's operations and more
    assert work["frame"]["f32_ops"] >= work["contract"]["f32_ops"]
    assert work["frame"]["bytes"] >= 4 * 3.19e9


def test_the_contraction_count_at_a_small_size():
    """At the tests' size every sum is below the einsum threshold; with
    the threshold at 1 each projection, norm, SSD product, attention
    product and the LM head counts, the last layer's at its last position
    or chunk only."""
    from halide_tpu_torch import eval_torch
    cfg = granite_config.config(SMALL, {"s": [64, 2]})
    cell = _cell()
    cell.config, cell.size = cfg, [64, 2]
    app = frames.build_app(cell)
    for spec, param in zip(cfg["inputs"], app.inputs):
        param.set(torch.empty(frames.resolve_shape(spec["shape"], [64, 2]),
                              dtype=getattr(torch, spec["dtype"]),
                              device="meta"))
    assert count_granite.contractions(app) == []
    saved = eval_torch._EINSUM_MIN_FULL
    eval_torch._EINSUM_MIN_FULL = 1
    try:
        parts = {n: (m, o, r) for n, m, o, r in
                 count_granite.contractions(app)}
    finally:
        eval_torch._EINSUM_MIN_FULL = saved
    # 3 mixers of 9 sums and an attention layer of 7, each with 3 of its
    # own norm and MLP, and the final norm and the LM head
    assert len(parts) == 3 * 12 + 10 + 2
    T, B, H = 64, 2, 64
    proj = 2 * 64 + 2 * 16 + 4                  # z, x, B, C and dt
    assert parts["l0_zxbcdt"] == (T * B * proj * H, proj * H + H * T * B,
                                  proj * T * B)
    assert parts["l2_scores"][0] == T * T * 4 * B * 16
    assert parts["logits"] == (512 * B * H, 512 * H + H * B, 512 * B)
    # the last layer's MLP at its last position
    assert parts["l3_mlp_out"][2] == H * B
    assert math.prod([4, 16, 16, 3, B]) == parts["l0_S"][2]


def _small_cell(monkeypatch):
    """The cell at the tests' size, its ring 2 frames as at full size."""
    monkeypatch.setattr(frames, "RING_MIN_BYTES", 100_000)
    cell = _cell()
    cell.config = granite_config.config(SMALL, {"prefill4k": [64, 2]})
    cell.size = [64, 2]
    return cell


def test_the_ring_holds_two_prompts_and_the_embedding_once(monkeypatch):
    """At full size the ring's bytes a frame are a prompt and the
    embedding table, so the ring is 2 prompts; the table is one tensor in
    every slot."""
    cell = _cell()
    ring = [s for s in cell.config["inputs"] if s.get("ring")]
    assert [s["name"] for s in ring] == ["tokens", "embed"]
    per_frame = sum(math.prod(frames.resolve_shape(s["shape"], cell.size))
                    * 4 for s in ring)
    assert frames.ring_length(per_frame) == 2
    small = _small_cell(monkeypatch)
    inputs = frames.make_inputs(small, 2 ** 31 + 11, "cpu")
    assert inputs.frames == 2
    embed, tokens = inputs.ring["embed"], inputs.ring["tokens"]
    assert embed[0].data_ptr() == embed[1].data_ptr()
    assert embed[0].is_contiguous() and embed[0].std() > 0.01
    assert not torch.equal(tokens[0], tokens[1])
    assert int(tokens.min()) >= 0 and int(tokens.max()) < 512


@pytest.mark.parametrize("fault", [None, stale], ids=["sound", "stale"])
def test_a_stale_frame_is_not_correct(fault, monkeypatch):
    """A run at the tests' size: sound, it is correct; with every frame
    given the first one's logits, the other prompt's check fails."""
    torch.set_num_threads(1)
    cell = _small_cell(monkeypatch)
    cell.traffic = dict(cell.traffic, check_frames=16)
    units = {m["name"]: m["unit"] for m in
             load_json(ROOT / "BENCHMARK.json")["end_to_end"]}
    wrap = None if fault is None else (lambda stream: fault(cell, stream))
    res = run.run_cell(cell, 2 ** 31 + 5, 0.5, False, "cpu",
                       time.perf_counter(), units, wrap=wrap)["result"]
    assert res["correct"] is (fault is None)
    assert (res["failed"] == 0) is (fault is None)


def test_readings_separate_the_program_from_the_control(monkeypatch):
    torch.set_num_threads(1)
    cell = _small_cell(monkeypatch)
    limits = cell.config["check"]["limits"]
    prog, _app = readings.program_readings(cell, 2 ** 31 + 7, "cpu")
    assert all(prog[k] <= limits[k] for k in limits)
    ctrl = readings.control_readings(
        cell, 2 ** 31 + 7, "cpu",
        getattr(torch, cell.config["check"]["control_dtype"]))
    assert any(ctrl[k] > limits[k] for k in limits)

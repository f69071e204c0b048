"""The benchmark's arithmetic, from host-clock times, profiler intervals and
frozen work counts."""
import pytest

from bench_h100 import peaks, stats
from bench_h100.profile import Profile
from bench_h100.spec import load_module, HERE


def test_frame_ms_is_the_window_over_its_frames():
    assert stats.frame_ms(30.0, 600) == pytest.approx(50.0)
    with pytest.raises(ValueError):
        stats.frame_ms(1.0, 0)


def test_p95_is_over_every_frame_by_nearest_rank():
    vals = list(range(1, 101))           # 1..100
    assert stats.p95(vals) == 95
    assert stats.p95([5.0] * 19 + [100.0]) == 5.0
    assert stats.p95([5.0] * 18 + [100.0] * 2) == 100.0
    assert stats.p95([3.0]) == 3.0


@pytest.mark.parametrize("intervals,union,gaps", [
    ([], 0.0, []),
    ([(0, 10)], 10.0, []),
    ([(0, 10), (5, 12)], 12.0, []),
    ([(0, 10), (2, 3), (20, 25)], 15.0, [(10, 20)]),
    ([(20, 25), (0, 10), (10, 12)], 17.0, [(12, 20)]),
])
def test_union_and_gaps_of_kernel_intervals(intervals, union, gaps):
    assert stats.union_length(intervals) == pytest.approx(union)
    assert stats.gaps(intervals) == gaps


def test_least_time_takes_the_larger_bound():
    s, b = stats.least_time_s({"bytes": 3.35e9, "f32_ops": 0, "int_ops": 0})
    assert (s, b) == (pytest.approx(1e-3), "bytes")
    s, b = stats.least_time_s({"bytes": 1, "f32_ops": 67e9, "int_ops": 1})
    assert (s, b) == (pytest.approx(1e-3), "f32")
    s, b = stats.least_time_s({"bytes": 1, "f32_ops": 1,
                               "int_ops": peaks.INT32_OPS_PER_S * 2e-3})
    assert (s, b) == (pytest.approx(2e-3), "int32")
    assert peaks.INT32_OPS_PER_S == pytest.approx(16.7e12, rel=0.01)


def _profile():
    # two frames: K1 100 us each, torch ops 50 + 30 us, a copy 20 us
    kernels = [("group_abc", 0, 100), ("aten_add", 100, 150),
               ("Memcpy DtoD", 400, 420), ("group_abc", 1000, 1100),
               ("aten_mul", 1100, 1130)]
    host = [("bench.frame", -5, 990), ("aten::mul", 200, 350),
            ("bench.frame", 995, 2000)]
    return Profile(2, 2000.0, kernels, host, 2, 2)


def _read(name, rec):
    return load_module(HERE / "metrics" / f"{name}.py").read(rec)


def test_readers_over_a_profile():
    p = _profile()
    work = {"k1": {"bytes": 3.35e6, "f32_ops": 0, "int_ops": 0},
            "frame": {"bytes": 0, "f32_ops": 67e6, "int_ops": 0}}

    class S:
        def __init__(self, call, ret):
            self.bind, self.call, self.ret, self.done = call, call, ret, ret

    setup = {"torch_import_s": 8.0, "port_import_s": 0.125,
             "cuda_context_s": 0.25, "input_ring_s": 0.05,
             "app_build_s": 0.125, "planning_realize_s": 0.75,
             "warmup_s": 0.5}
    rec = {"profile": p, "work": work, "frame_ms": 2.0, "setup": setup,
           "spans": [S(0.0, 0.001), S(1.0, 1.003)]}
    assert _read("k1.device_ms", rec) == pytest.approx(0.1)
    assert _read("eval_torch.device_ms", rec) == pytest.approx(0.05)
    # K1's least time 1 us against 100 us a frame
    assert _read("k1_roofline", rec) == pytest.approx(1.0)
    # busy 100 + 50 + 20 + 100 + 30 of 2000 us
    assert _read("device.idle_share", rec) == pytest.approx(85.0)
    # the frame's least time 1 us against 2 ms a frame
    assert _read("frame_mfu", rec) == pytest.approx(0.05)
    assert _read("pipeline.host_ms", rec) == pytest.approx(2.0)
    # the port's import, the app's build and the planning realize
    assert _read("setup.port_s", rec) == pytest.approx(1.0)
    assert p.top_ops(2) == [["group_abc", pytest.approx(200e-6)],
                            ["aten_add", pytest.approx(50e-6)]]
    gaps = dict(p.idle_by_host())
    # 150-400 holds aten::mul's middle (275); 420-1000 bench.frame's
    assert gaps == {"aten::mul": pytest.approx(250e-6),
                    "bench.frame": pytest.approx(580e-6)}


def test_readers_find_nothing_return_nothing():
    rec = {"profile": None, "work": {}, "frame_ms": 2.0, "spans": []}
    for name in ("k1.device_ms", "eval_torch.device_ms", "k1_roofline",
                 "device.idle_share", "frame_mfu", "pipeline.host_ms",
                 "setup.port_s"):
        assert _read(name, rec) is None
    empty = Profile(2, 2000.0, [("aten_add", 0, 10)], [], 0, 0)
    rec = {"profile": empty, "work": {"k1": {"bytes": 1, "f32_ops": 1,
                                             "int_ops": 1}},
           "frame_ms": 2.0, "spans": []}
    assert _read("k1_roofline", rec) is None
    assert _read("k1.device_ms", rec) is None


@pytest.mark.parametrize("name,size,tile", [
    ("local_laplacian", [96, 64], [32, 16]),
    ("camera_pipe", [256, 128], [256, 64])])
def test_count_work_at_a_small_size(name, size, tile):
    """The frozen work's counter, on the CPU: one K1 group; the frame's
    bytes are its inputs and output once; K1 reads at least its output's
    region of every window."""
    import torch
    from bench_h100.spec import Cell, load_json
    from bench_h100.tools.count_work import count
    torch.set_num_threads(1)
    config = load_json(HERE / "configs" / f"{name}.json")
    config["args"]["tile"] = tile
    cell = Cell(name, 1, config, {"size": "x"}, size, {})
    work = count(cell, "cpu")
    w, h = size
    if name == "camera_pipe":
        frame_bytes = (w + 32) * (h + 48) * 2 + 2 * 12 * 4 + w * h * 3
    else:
        frame_bytes = 2 * (w * h * 3 * 2)
    assert work["frame"]["bytes"] == frame_bytes
    assert work["k1"]["launches"] == 1
    assert work["k1"]["bytes"] > work["frame"]["bytes"] // 2
    assert work["k1"]["int_ops"] > 0 and work["k1"]["f32_ops"] > 0
    assert work["frame"]["f32_ops"] >= work["k1"]["f32_ops"]

"""The resnet_50 cell's parts found by name, and its readings at a small
size on the CPU: the program within the configuration's limit, the
lower-precision control past it."""
import pytest
import torch

from bench_h100 import frames
from bench_h100.run import ROOT
from bench_h100.spec import find_cell, load_json
from bench_h100.tools import readings, resnet_config


def test_the_cell_and_its_metrics_are_found_by_name():
    cell = find_cell(load_json(ROOT / "BENCHMARK.json"), "resnet_50.batch128")
    assert cell.size == [224, 128] and cell.chips == 1
    assert {"contract.device_ms", "contract_roofline", "glue.device_ms",
            "contract.library_share", "pipeline.host_ms", "frame_mfu",
            "device.idle_share"} <= set(cell.metrics)
    assert "eval_torch.launches" not in cell.metrics
    assert cell.compare().__name__.endswith("relative")
    for name in cell.metrics:
        assert callable(cell.reader(name).read)
    if cell.work:
        assert set(cell.work) == {"frame", "contract"}


@pytest.mark.parametrize("layers", [(1, 1, 1, 1), (3, 4, 6, 3)])
def test_readings_separate_the_program_from_the_control(layers,
                                                         monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(frames, "RING_MIN_BYTES", 10_000)
    cell = find_cell(load_json(ROOT / "BENCHMARK.json"), "resnet_50.batch128")
    cell.config = resnet_config.config(layers, 8, 10, {"batch128": [32, 2]})
    cell.size = [32, 2]
    limits = cell.config["check"]["limits"]
    prog, _app = readings.program_readings(cell, 5, "cpu")
    assert all(prog[k] <= limits[k] for k in limits)
    ctrl = readings.control_readings(
        cell, 5, "cpu", getattr(torch, cell.config["check"]["control_dtype"]))
    assert any(ctrl[k] > limits[k] for k in limits)

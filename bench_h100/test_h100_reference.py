"""The frozen plain references against the port's app goldens (numpy) at a
small size: camera_pipe bit for bit, local_laplacian within the app's own
rule (2 steps of u16 on all but 0.3% of the values); and the lower-
precision control, which has to read as wrong."""
import numpy as np
import pytest
import torch

from bench_h100.spec import HERE, load_json, load_module

CASES = [("camera_pipe", {"out_width": 256, "out_height": 128}),
         ("camera_pipe", {"out_width": 512, "out_height": 256}),
         ("local_laplacian", {"width": 96, "height": 64}),
         ("local_laplacian", {"width": 256, "height": 192})]


def _reference_args(name):
    config = load_json(HERE / "configs" / f"{name}.json")
    return config, {k: v for k, v in config["args"].items()
                    if k not in ("tile", "kernel")}


@pytest.mark.parametrize("name,size", CASES)
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_reference_against_the_apps_golden(name, size, seed):
    from halide_tpu_torch.apps import get
    torch.set_num_threads(1)
    config, args = _reference_args(name)
    app = get(name)(**size, **args)
    data = app.make_inputs(seed % 2 ** 32)
    golden = app.reference(**data).astype(np.int64)
    ref = load_module(HERE / "reference" / f"{name}.py")
    mine = ref.reference({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in data.items()}, config["args"])
    mine = mine.numpy().astype(np.int64)
    assert mine.shape == golden.shape
    d = np.abs(mine - golden)
    if app.atol == 0:
        assert d.max() == 0
    else:
        assert (d > app.atol).mean() <= app.mismatch_frac


@pytest.mark.parametrize("name,size", CASES[::2])
def test_lower_precision_control_is_not_correct(name, size):
    torch.set_num_threads(1)
    from bench_h100.frames import make_inputs
    from bench_h100.spec import Cell
    config, _args = _reference_args(name)
    wk, hk = config["size_args"]
    cell = Cell(name, 1, config, {"size": "x"}, [size[wk], size[hk]], {})
    inputs = make_inputs(cell, 7, "cpu", frames=1)
    ref = load_module(HERE / "reference" / f"{name}.py")
    cmp = load_module(HERE / "compare" / f"{config['check']['kind']}.py")
    want = ref.reference(inputs.frame(0), config["args"])
    got = ref.reference(inputs.frame(0), config["args"],
                        getattr(torch, config["check"]["control_dtype"]))
    nums = cmp.numbers(got, want, config["check"])
    assert any(v > config["check"]["limits"][k] for k, v in nums.items())


@pytest.mark.parametrize("workload,size,tile", [
    ("local_laplacian.frames", [96, 64], [32, 16]),
    ("camera_pipe.frames", [256, 128], [256, 64])])
def test_readings_separate_the_program_from_the_control(workload, size,
                                                         tile, monkeypatch):
    """The readings tool, at a small size on the CPU: the program's
    numbers within every limit, the control's past one of them."""
    from bench_h100 import frames
    from bench_h100.run import ROOT
    from bench_h100.spec import find_cell
    from bench_h100.tools import readings
    torch.set_num_threads(1)
    cell = find_cell(load_json(ROOT / "BENCHMARK.json"), workload)
    cell.size, cell.config["args"]["tile"] = size, tile
    monkeypatch.setattr(frames, "RING_MIN_BYTES", 100_000)
    limits = cell.config["check"]["limits"]
    prog, _app = readings.program_readings(cell, 5, "cpu")
    assert all(prog[k] <= limits[k] for k in limits)
    ctrl = readings.control_readings(
        cell, 5, "cpu", getattr(torch, cell.config["check"]["control_dtype"]))
    assert any(ctrl[k] > limits[k] for k in limits)

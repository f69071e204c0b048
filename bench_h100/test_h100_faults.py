"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip is skipped and the rest of a run is driven on the
CPU at a small size, with each fault a cell can have put under
`Pipeline.realize` (one chip, so no exchange between chips to leave out),
and with the lower-precision control in the program's place."""
import time

import pytest
import torch

from bench_h100 import frames, run
from bench_h100.spec import HERE, find_cell, load_json

SMALL = {"local_laplacian.frames": ([96, 64], [32, 16]),
         "camera_pipe.frames": ([256, 128], [256, 64])}


class Out:
    def __init__(self, data):
        self.data = data


def stale(cell, stream):
    """A step that returns its state unchanged: every frame after the first
    gives the first frame's output."""
    realize, first = stream.realize, []

    def call(*a, **k):
        if not first:
            first.append(realize(*a, **k))
        return first[0]
    return call


def half(cell, stream):
    """Half of the frame left out: the lower half of its rows never
    written."""
    realize = stream.realize

    def call(*a, **k):
        out = realize(*a, **k)
        t = out.data
        t[..., t.shape[-2] // 2:, :] = 0
        return out
    return call


def altered(cell, stream):
    """An answer altered where it is produced: one value of every frame's
    output, its second-highest bit flipped."""
    realize = stream.realize

    def call(*a, **k):
        out = realize(*a, **k)
        t = out.data
        flat = t.view(torch.int16 if t.element_size() == 2 else torch.int8)
        bit = 1 << (8 * t.element_size() - 2)
        flat.view(-1)[t.numel() // 3] ^= bit
        return out
    return call


def control(cell, stream):
    """The lower-precision control in the program's place: the plain
    reference computed in the configuration's `control_dtype` on the bound
    inputs."""
    ref = cell.reference()
    dtype = getattr(torch, cell.config["check"]["control_dtype"])

    def call(*a, **k):
        inputs = {n: p.get().data for n, p in stream.params.items()}
        return Out(ref.reference(inputs, cell.config["args"], dtype))
    return call


FAULTS = {"stale": stale, "half": half, "altered": altered}


@pytest.fixture(autouse=True)
def small_ring(monkeypatch):
    """A ring of a few frames at the small sizes."""
    monkeypatch.setattr(frames, "RING_MIN_BYTES", 100_000)


def _run(workload, fault, trace=False, seed=2 ** 31 + 3):
    torch.set_num_threads(1)
    benchmark = load_json(HERE.parent / "BENCHMARK.json")
    cell = find_cell(benchmark, workload)
    cell.size, tile = SMALL[workload]
    cell.config["args"]["tile"] = tile
    units = {m["name"]: m["unit"]
             for m in benchmark["end_to_end"] + benchmark["per_layer"]}
    wrap = None if fault is None else (lambda stream: fault(cell, stream))
    return run.run_cell(cell, seed, 0.3, trace, "cpu", time.perf_counter(),
                        units, wrap=wrap)["result"]


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(workload, trace):
    res = _run(workload, None, trace)
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_under_the_timed_path_is_not_correct(workload, fault):
    res = _run(workload, FAULTS[fault])
    assert res["correct"] is False
    assert res["failed"] >= 1


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_in_the_programs_place_is_not_correct(workload):
    res = _run(workload, control)
    assert res["correct"] is False

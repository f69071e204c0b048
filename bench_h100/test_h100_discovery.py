"""A configuration, a traffic mix and a per-layer metric are each new files
and entries: in a copy of this folder, added beside the others, they are
found by name and run, and no file that was there changes."""
import hashlib
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from bench_h100 import frames, run
from bench_h100.spec import HERE, find_cell, load_json


def _digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha1(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_are_files_and_entries(tmp_path,
                                                         monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(frames, "RING_MIN_BYTES", 100_000)
    root = tmp_path / "bench_h100"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "test_*", "conftest.py"))
    before = _digests(root)

    config = load_json(root / "configs" / "camera_pipe.json")
    config.update(name="camera_pipe_small", sizes={"tiny": [256, 128]})
    config.pop("work", None)
    (root / "configs" / "camera_pipe_small.json").write_text(
        json.dumps(config))
    shutil.copy(root / "reference" / "camera_pipe.py",
                root / "reference" / "camera_pipe_small.py")
    (root / "traffic" / "tiny.json").write_text(json.dumps(
        {"size": "tiny", "check_frames": 2}))
    (root / "metrics" / "window.frames.py").write_text(
        "def read(rec):\n    return float(len(rec['spans']))\n")

    benchmark = load_json(HERE.parent / "BENCHMARK.json")
    benchmark["configs"].append({"name": "camera_pipe_small"})
    benchmark["workloads"].append(
        {"name": "camera_pipe_small.tiny", "config": "camera_pipe_small",
         "traffic": "tiny", "chips": 1})
    benchmark["per_layer"].append(
        {"name": "window.frames", "unit": "frames", "better": "higher",
         "moves": "frame_ms"})
    cell = find_cell(benchmark, "camera_pipe_small.tiny", root)
    assert cell.size == [256, 128]
    assert "window.frames" in cell.metrics
    assert "k1.device_ms" not in cell.metrics     # it names its cells
    units = {m["name"]: m["unit"]
             for m in benchmark["end_to_end"] + benchmark["per_layer"]}
    out = run.run_cell(cell, 11, 0.3, True, "cpu", time.perf_counter(),
                       units)
    res = out["result"]
    assert res["correct"] is True
    assert res["metrics"]["window.frames"]["value"] == res["attempted"]
    assert res["metrics"]["window.frames"]["unit"] == "frames"
    after = _digests(root)
    assert {k: after[k] for k in before} == before


def test_an_unknown_cell_or_size_is_refused():
    benchmark = load_json(HERE.parent / "BENCHMARK.json")
    with pytest.raises(KeyError):
        find_cell(benchmark, "nope.frames")
    benchmark["workloads"].append({"name": "x", "config": "camera_pipe",
                                   "traffic": "frames", "chips": 1})
    cell = find_cell(benchmark, "x")
    assert cell.size == [2560, 1920]

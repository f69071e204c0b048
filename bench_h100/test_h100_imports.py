"""Nothing the benchmark runs loads JAX or the JAX package, by top-level
module name compared whole (the port's halide_tpu_torch begins with the
JAX package's name), and the plain references load nothing of the program
under test: each checked in a fresh process."""
import json
import subprocess
import sys

from bench_h100.spec import HERE

ROOT = HERE.parent


def _loaded(code: str) -> set:
    r = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in "
                        "sys.modules})))"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_what_the_benchmark_runs_loads_no_jax():
    code = """
import bench_h100.run, bench_h100.frames, bench_h100.profile
import bench_h100.tools.count_work, bench_h100.tools.readings
from bench_h100.spec import HERE, load_module
for d in ("configs", "metrics", "reference", "inputs", "compare"):
    for p in sorted((HERE / d).glob("*.py")):
        load_module(p)
from halide_tpu_torch.apps import get
get("local_laplacian"); get("camera_pipe")
"""
    loaded = _loaded(code)
    assert "halide_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "halide_tpu"}


def test_the_references_load_nothing_of_the_program():
    code = """
from bench_h100.spec import HERE, load_module
for p in sorted((HERE / "reference").glob("*.py")):
    load_module(p)
"""
    loaded = _loaded(code)
    assert not loaded & {"jax", "jaxlib", "flax", "halide_tpu",
                         "halide_tpu_torch"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import halide_tpu_torch  # noqa: F401
    from bench_h100 import run
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "halide_tpu.apps", sys)
    monkeypatch.setitem(sys.modules, "jaxlib_probe_not_jax", sys)
    assert run.forbidden_modules() == ["halide_tpu"]


def test_no_card_no_result():
    """Without a CUDA device a run prints no result and exits with 1: it
    never falls back to the CPU."""
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "bench_h100.run", "--workload",
                        "camera_pipe.frames", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 1
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr

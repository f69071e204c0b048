"""One short cell on the card, through the benchmark's own command (runs
only where there is a CUDA device: the `gpu` marker, and a skip decided in
the fixture)."""
import json
import subprocess
import sys

import pytest

from bench_h100.spec import HERE


@pytest.mark.gpu
def test_one_short_cell_on_the_card(cuda_device):
    r = subprocess.run([sys.executable, "-m", "bench_h100.run", "--workload",
                        "camera_pipe.frames", "--seed", str(2 ** 31 + 11),
                        "--seconds", "2", "--trace", "1"], cwd=HERE.parent,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    assert set(res["metrics"]) >= {"k1.device_ms", "k1_roofline",
                                   "device.idle_share"}

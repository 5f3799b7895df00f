"""On the card: one short run of each cell of BENCHMARK.json, started as
BENCHMARK.json's command, comes out correct and prints the contract's last
line. Skips where there is no CUDA card (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_on_the_card_is_correct(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "lsr_bench/run.py", "--workload", workload, "--seed",
                        "2147483999", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1

"""The output check: the plain reference against the port at the tiny preset
on the CPU, the result line's keys, and that the control and every fault a
cell can have come out as not correct.

Each case drives the rest of a run (set-up, a short window, the check) and
skips only the harness's look for a card."""

import json
import time

import pytest

from lsr_bench import harness

from conftest import LATER, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run(cell, seconds=1.0):
    return harness.run_cell(cell, seconds, False, time.perf_counter())


MESH4 = {"mesh_positions": 4}  # the train traffic over four CPU positions of one mesh


@pytest.mark.parametrize("workload,extra", [("mini-train", {}), ("mini-train-mesh4", MESH4),
                                            ("distil-ingest", {}), ("distil-search-2m", {})])
def test_reference_equals_the_port_in_float32(workload, extra):
    """With the port computing in float32 the comparison reads round-off
    alone: a fault in the reference (tokens, dropout masks, order of the
    rows, loss, AdamW, rows, scores) would read far above it."""
    out = run(tiny_cell(workload.replace("-mesh4", ""), compute="float32", **extra))
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] <= 1e-5, (name, c)


@pytest.mark.parametrize("workload", ["mini-train", "distil-ingest", "distil-search-2m"])
def test_result_line(workload, capsys):
    out = run(tiny_cell(workload, compute="float32"))
    assert out["correct"], out["checks"]
    assert list(out) == KEYS  # the compared numbers come last
    assert out["device"]["count"] == 1 and "memory_peak_bytes" in out["device"]
    cell = harness.load_cell(workload, more=LATER)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    harness.print_result(out)
    o, e = capsys.readouterr()
    assert json.loads(o.strip().splitlines()[-1]) == json.loads(json.dumps(out))
    assert e.strip().splitlines()[-1].startswith("check ")
    assert harness.forbidden_modules() == []


@pytest.mark.parametrize("workload,fault", [
    ("mini-train", "frozen"), ("mini-train", "half_batch"), ("mini-train", "token"),
    ("mini-train-mesh4", "no_exchange"),
    ("distil-ingest", "token"), ("distil-ingest", "answer"),
    ("distil-search-2m", "answer"),
])
def test_a_planted_fault_is_not_correct(workload, fault):
    extra = MESH4 if workload.endswith("-mesh4") else {}
    out = run(tiny_cell(workload.replace("-mesh4", ""), fault=fault, **extra))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", ["mini-train", "distil-ingest", "distil-search-2m"])
def test_the_control_fails_a_limit(workload):
    """The reference at float8 in the program's place fails at least one of
    the cell's committed limits."""
    cell = tiny_cell(workload)
    driver = harness.load_driver(cell)
    if hasattr(driver, "setup_for_control"):
        driver.setup_for_control(2)
    else:
        driver.setup()
        driver.unit()
    nums = driver.control()
    lim = cell.traffic["limits"]
    assert any(nums[k] > lim[k] for k in lim if k in nums), nums

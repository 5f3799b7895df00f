"""Every file BENCHMARK.json names loads by name, and a new configuration,
traffic mix or per-layer metric is new files plus new entries."""

import json
import os
import shutil

import pytest

from lsr_bench import harness

from conftest import LATER

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = BENCH["workloads"] + LATER["workloads"]


@pytest.mark.parametrize("workload", [w["name"] for w in CELLS])
def test_every_cell_loads_its_files_and_driver(workload):
    """The committed cells, and those whose files are here and whose entries
    are not yet (tests/later_cells.json)."""
    cell = harness.load_cell(workload, more=LATER)
    assert cell.chips == next(w["chips"] for w in CELLS if w["name"] == workload)
    assert set(cell.traffic["limits"])
    driver = harness.load_driver(cell)
    assert hasattr(driver, "setup") and hasattr(driver, "check")
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:  # each per-layer metric moves an end-to-end metric of the cell
        assert m["moves"] in names


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"] + LATER["per_layer"]])
def test_every_metric_reader_loads(metric):
    assert callable(harness.load_reader(harness.BENCH_DIR, metric))


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("lsr_bench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    """A throwaway configuration, traffic mix and metric, added as files and
    entries of a copy of BENCHMARK.json, load without an edit to any file."""
    bench_dir = tmp_path / "lsr_bench"
    shutil.copytree(harness.BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    cfg = json.load(open(bench_dir / "configs" / "bert-mini.json"))
    cfg["num_hidden_layers"] = 2
    (bench_dir / "configs" / "bert-mini-2l.json").write_text(json.dumps(cfg))
    tr = json.load(open(bench_dir / "traffic" / "infonce-15x3.json"))
    tr["query_words"] = [1, 4]
    (bench_dir / "traffic" / "short-queries.json").write_text(json.dumps(tr))
    (bench_dir / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return run.second.total('steps') or None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "bert-mini-2l", "source": "x",
                             "file": "lsr_bench/configs/bert-mini-2l.json",
                             "reduced": ["num_hidden_layers"], "why": "x"})
    bench["workloads"].append({"name": "mini2-short", "config": "bert-mini-2l",
                               "traffic": "short-queries", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "train_docs_per_s", "unit": "docs/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["mini2-short"]})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "train loop",
                               "moves": "train_docs_per_s", "workloads": ["mini2-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("mini2-short", str(tmp_path / "BENCHMARK.json"), str(bench_dir))
    assert cell.config["num_hidden_layers"] == 2 and cell.traffic["query_words"] == [1, 4]
    assert "steps_in_window" in [m["name"] for m in cell.per_layer]
    run = harness.Run(cell, None, harness.Half(), harness.Half(1.0, [{"steps": 3}]), None)
    assert harness.load_reader(str(bench_dir), "steps_in_window")(run) == 3
    for p, data in before.items():
        assert p.read_bytes() == data


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """Where the port is missing (a checkout of only BENCHMARK.json and
    lsr_bench/) or no card is found, the run fails and prints no result."""
    import subprocess
    import sys

    shutil.copytree(harness.BENCH_DIR, tmp_path / "lsr_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    for cwd in (tmp_path, ROOT):
        p = subprocess.run([sys.executable, "lsr_bench/run.py", "--workload", "distil-ingest",
                            "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                           capture_output=True, text=True, timeout=300,
                           env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert p.returncode != 0
        assert '"correct"' not in p.stdout


def test_the_harness_loads_nothing_of_jax():
    """No module the harness imports has jax, jaxlib, flax or the JAX package
    as its whole top-level name (the port's name begins with the JAX
    package's, so the comparison is of whole names)."""
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); "
            "import lsr_bench.harness, lsr_bench.calibrate, lsr_bench.drivers.train, "
            "lsr_bench.drivers.ingest, lsr_bench.drivers.search, lsr_bench.reference.bert, "
            "lsr_bench.reference.train, lsr_bench.reference.wordpiece, lsr_bench.gen.corpus, "
            "lsr_bench.gen.text; "
            "from lsr_bench.drivers import common; common.program_model; "
            "import opensearch_sparse_model_tuning_sample_torch.train.trainer, "
            "opensearch_sparse_model_tuning_sample_torch.eval.beir, "
            "opensearch_sparse_model_tuning_sample_torch.index.engine; "
            "print(lsr_bench.harness.forbidden_modules())" % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
    refs = os.path.join(harness.BENCH_DIR, "reference")
    for f in os.listdir(refs):  # the reference imports nothing of the program
        if f.endswith(".py"):
            assert "opensearch_sparse_model_tuning_sample" not in open(os.path.join(refs, f)).read()

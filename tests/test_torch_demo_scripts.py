"""The port's demo scripts on the CPU: `run_ft_demo_torch.sh` (cli.mine ->
cli.train_ir -> cli.evaluate_beir) on configs/smoke.yaml, and
`run_train_eval_torch.sh` over a config list, each with `--device cpu` and
their outputs under `tmp_path` (the working directory, where cli.mine saves
`data/synthetic_train`)."""

import json
import os
import subprocess

import pytest
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDF = os.path.join(REPO, "assets", "idf.npz")


def _run(script, args, cwd, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run(["bash", os.path.join(REPO, script), *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=timeout)
    return out.returncode, out.stdout + out.stderr


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("demo")
    rc, log = _run("run_ft_demo_torch.sh",
                   [os.path.join(REPO, "configs", "smoke.yaml"), "--device", "cpu",
                    "--output_dir", str(tmp / "out"), "--idf_path", IDF,
                    "--max_steps", "6", "--save_steps", "6"], tmp)
    assert rc == 0, log[-3000:]
    return tmp


def test_ft_demo_mines_trains_and_evaluates_on_the_cpu(demo):
    assert os.path.isdir(demo / "data" / "synthetic_train")
    summary = json.load(open(demo / "out" / "run_summary.json"))
    assert summary["steps"] == 6 and summary["device"] == "cpu" and summary["mesh"] == ["cpu"]
    assert summary["plains"]["maxpool_head_argmax_reference"] == 6  # the CPU's plain head
    for f in ("model.safetensors", "config.json"):
        assert os.path.exists(demo / "out" / "checkpoint-6" / f)
    avg = json.load(open(demo / "out" / "beir_eval" / "avg_res.json"))
    assert 0.0 <= avg["NDCG@10"] <= 1.0


def test_train_eval_runs_each_config_and_skips_missing_ones(demo):
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs", "smoke.yaml")))
    cfg.update(idf_path=IDF, train_file=str(demo / "data" / "synthetic_train"),
               output_dir=str(demo / "again"), max_steps=4, save_steps=4)
    path = demo / "again.yaml"
    path.write_text(yaml.safe_dump(cfg))
    rc, log = _run("run_train_eval_torch.sh",
                   ["--device", "cpu", str(demo / "missing.yaml"), str(path)], demo)
    assert rc == 0, log[-3000:]
    assert "warning: no such config" in log and f"=== done: {path} ===" in log
    assert json.load(open(demo / "again" / "run_summary.json"))["steps"] == 4
    assert os.path.exists(demo / "again" / "beir_eval" / "avg_res.json")

    rc, log = _run("run_train_eval_torch.sh", ["--device", "cpu"], demo)
    assert rc == 1 and "Usage:" in log

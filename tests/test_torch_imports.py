"""The PyTorch port stands alone: importing every module of it loads neither
jax nor the JAX package, and its entry points run on the card unless the
caller asks for the CPU."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import opensearch_sparse_model_tuning_sample_torch as port
from opensearch_sparse_model_tuning_sample_torch.core import device as dev_mod
from opensearch_sparse_model_tuning_sample_torch.core.config import parse_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(port.__path__, prefix=port.__name__ + ".")
    )


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for name in ("core.device", "core.config", "models.bert", "models.convert",
                 "models.hf_import", "models.sparse_encoder", "ops.maxpool",
                 "ops.activations", "index.engine", "eval.beir",
                 "cli.evaluate_beir"):
        assert f"{port.__name__}.{name}" in mods, name


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k.startswith('jaxlib')\n"
        "             or k.startswith('opensearch_sparse_model_tuning_sample_tpu'))\n"
        "print(len(bad), bad[:5])\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "0", out.stdout


def test_port_sources_never_name_jax():
    root = os.path.dirname(port.__file__)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            text = open(os.path.join(dirpath, f)).read()
            for line in text.splitlines():
                s = line.strip()
                assert not (s.startswith(("import jax", "from jax"))
                            or "sample_tpu import" in s
                            or s.startswith("from opensearch_sparse_model_tuning_sample_tpu")), (f, s)


@pytest.mark.parametrize("request_", [None, "cuda"])
def test_device_defaults_to_cuda_and_raises_without_a_card(monkeypatch, request_):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dev_mod.resolve_device(request_)


def test_cpu_only_on_request():
    assert dev_mod.resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError):
        dev_mod.resolve_device("mps")


def test_build_model_raises_without_a_card(monkeypatch):
    from opensearch_sparse_model_tuning_sample_torch.models.sparse_encoder import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(arch="tiny")


@pytest.mark.parametrize("argv,expect", [
    ([], "cuda"),
    (["--device", "cpu"], "cpu"),
    (["--device=cpu"], "cpu"),
])
def test_device_knob_is_a_cli_flag(tmp_path, monkeypatch, argv, expect):
    cfg = tmp_path / "c.yaml"
    cfg.write_text(f"output_dir: {tmp_path / 'out'}\narch: tiny\n")
    monkeypatch.setattr(sys, "argv", ["evaluate_beir", str(cfg), *argv])
    _, _, training_args = parse_config()
    assert training_args.device == expect


@pytest.mark.parametrize("name,dtype", [
    ("float32", torch.float32), ("bfloat16", torch.bfloat16), ("float16", torch.float16),
])
def test_dtype_strings(name, dtype):
    assert dev_mod.resolve_dtype(name) is dtype

"""The PyTorch port stands alone: importing every module of it loads neither
jax nor the JAX package, and its entry points run on the card unless the
caller asks for the CPU."""

import json
import os
import pkgutil
import re
import subprocess
import sys
import time
import urllib.request

import numpy as np
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
                 "ops.activations", "index.engine", "index.inverted", "eval.beir",
                 "cli.evaluate_beir", "ops.losses", "ops.flops", "data.datasets",
                 "data.collator", "data.loader", "train.trainer", "cli.train_ir",
                 "mine.hard_negatives", "cli.mine", "cli.serve", "cli.search",
                 "train.teachers", "train.embedding_store", "cli.make_kd_scores",
                 "core.distributed", "parallel.collectives", "cli.prepare_msmarco",
                 "cli.import_metrics", "core.mesh", "parallel.dryrun", "utils.tracing"):
        assert f"{port.__name__}.{name}" in mods, name


def test_make_mesh_is_a_lazy_top_level_name():
    """`make_mesh` from the package itself, as the JAX package exports it,
    loaded only when asked for."""
    code = (
        "import sys\n"
        f"import {port.__name__} as p\n"
        f"assert '{port.__name__}.core.mesh' not in sys.modules\n"
        f"from {port.__name__}.core.mesh import make_mesh\n"
        "assert p.make_mesh is make_mesh\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_mesh_without_a_card_raises(monkeypatch):
    """A mesh never quietly becomes the CPU: without a card, neither the
    default mesh nor an index on it can be made."""
    from opensearch_sparse_model_tuning_sample_torch.core.mesh import make_mesh, process_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        process_mesh(torch.device("cuda", 0))


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


def _assert_imports_no_jax(script):
    for line in open(os.path.join(REPO, script)).read().splitlines():
        s = line.strip()
        is_import = s.startswith(("import ", "from "))
        assert not (is_import and ("jax" in s or "sample_tpu" in s)), s


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py runs on the card's machine, which has no JAX."""
    _assert_imports_no_jax("chip_smoke.py")


_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118moe_combine_kernelEPfii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118moe_combine_kernelEPfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115moe_down_kernelE14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115moe_down_kernelE14CUtensorMap_st
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized \
in the function '_ZN12_GLOBAL__N_118moe_gate_up_kernelE14CUtensorMap_st'
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118moe_gate_up_kernelE14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118moe_gate_up_kernelE14CUtensorMap_st
    24 bytes stack frame, 24 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 24 bytes cumulative stack size
"""


def test_chip_smoke_reads_registers_spills_and_serialised_wgmmas_from_nvcc():
    """chip_smoke.py's report of the expert kernels' build (step 3d): per
    kernel asked for, ptxas's registers, spill bytes and any C75xx note that
    it serialised the wgmmas; other kernels of the log left out."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    got = cs.ptxas_resources(_PTXAS_LOG, ["moe_gate_up_kernel", "moe_down_kernel"])
    assert got["moe_down_kernel"] == {"registers": 168, "spill_stores": 0, "spill_loads": 0,
                                      "notes": []}
    gate_up = got["moe_gate_up_kernel"]
    assert (gate_up["registers"], gate_up["spill_stores"], gate_up["spill_loads"]) == (168, 24, 20)
    assert len(gate_up["notes"]) == 1 and "(C7520)" in gate_up["notes"][0]
    assert set(got) == {"moe_gate_up_kernel", "moe_down_kernel"}


def test_compare_head_kernels_imports_no_jax():
    """compare_head_kernels.py runs on the card's machine too."""
    _assert_imports_no_jax("compare_head_kernels.py")


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
    from opensearch_sparse_model_tuning_sample_torch.train.teachers import build_ensemble

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(arch="tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_ensemble({"types": ["sparse"], "model_ids": ["tiny"]}, False)


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


def _tiny_index(path):
    from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig, SparseIndex

    idx = SparseIndex(30522, IndexConfig(engine="sparse", l_max=8, block_docs=8), device="cpu")
    toks = np.array([[1996, 4248, 0], [2829, 4419, 1996]], np.int32)  # the quick / brown fox the
    idx.add_topk(["a", "b"], toks, np.array([[2.0, 1.0, 0.0], [1.5, 1.0, 0.5]], np.float32))
    idx.finalize()
    idx.save(str(path))
    return str(path)


@pytest.mark.parametrize("cli", ["serve", "search", "make_kd_scores"])
def test_serving_clis_raise_without_a_card(tmp_path, monkeypatch, cli):
    import importlib

    main = importlib.import_module(f"{port.__name__}.cli.{cli}").main
    argv = {"serve": ["--index", f"x={tmp_path}"],
            "search": ["--index", str(tmp_path), "--queries", str(tmp_path / "q.txt")],
            "make_kd_scores": ["--posnegs", str(tmp_path), "--teacher", "tiny",
                               "--out", str(tmp_path / "kd")]}[cli]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv + ["--device", "cuda"])


def test_cli_search_runs_on_the_cpu_on_request(tmp_path, capsys):
    from opensearch_sparse_model_tuning_sample_torch.cli import search

    (tmp_path / "q.txt").write_text("q1\tthe quick fox\n")
    search.main(["--index", _tiny_index(tmp_path / "idx"), "--queries", str(tmp_path / "q.txt"),
                 "--arch", "tiny", "--device", "cpu", "--trec", str(tmp_path / "run.trec")])
    out = json.loads(capsys.readouterr().out)
    assert out["qid"] == "q1" and sorted(out["hits"]) == ["a", "b"]
    top = max(out["hits"], key=out["hits"].get)
    assert (tmp_path / "run.trec").read_text().startswith(f"q1 Q0 {top} 1 ")


def test_cli_serve_starts_as_a_module_on_the_cpu_on_request(tmp_path):
    """`python -m ...cli.serve --device cpu` serves: health, a token search."""
    cmd = [sys.executable, "-m", f"{port.__name__}.cli.serve", "--index",
           f"t={_tiny_index(tmp_path / 'idx')}", "--arch", "tiny", "--port", "0",
           "--device", "cpu", "--batch-window-ms", "0"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        url = None
        while url is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            assert line or proc.poll() is None, "the server exited"
            found = re.search(r"serving 1 index\(es\) on (http://\S+)", line)
            url = found.group(1) if found else None
        assert url, "the server never said where it listens"
        with urllib.request.urlopen(url + "/_health", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "green"}
        body = json.dumps({"query": {"neural_sparse": {"text_sparse": {
            "query_tokens": {"fox": 1.0, "the": 0.5}}}}, "size": 5}).encode()
        req = urllib.request.Request(url + "/t/_search", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            hits = json.loads(r.read())["hits"]["hits"]
        assert [h["_id"] for h in hits] == ["b", "a"]
        assert hits[0]["_score"] == pytest.approx(1.0 + 0.25) and hits[1]["_score"] == 1.0
    finally:
        proc.kill()
        proc.communicate(timeout=30)

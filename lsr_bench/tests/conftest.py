"""The benchmark's own tests: the repository's root on the import path, and
the small cells they run."""

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import json  # noqa: E402

import pytest  # noqa: E402

# entries of cells whose files are committed and whose BENCHMARK.json
# entries are not yet (their readings are in PERF.md)
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "later_cells.json")) as f:
    LATER = json.load(f)


def tiny_cell(name, seed=2**31 + 12345, fault=None, compute="bfloat16", mesh_positions=1):
    """A cell of BENCHMARK.json cut to a size the CPU runs in seconds: the
    configuration's widths cut to the port's `tiny` preset, the traffic's
    batch, corpus and query pool cut; everything else as committed.
    `traffic` and `chips` put another of the benchmark's traffic files in
    the cell's place (a mix that no committed cell runs yet)."""
    import torch

    from lsr_bench import harness

    torch.set_num_threads(4)
    cell = harness.load_cell(name, more=LATER)
    cfg, t = dict(cell.config), copy.deepcopy(cell.traffic)
    if "dim" in cfg:
        cfg.update(dim=128, n_layers=2, n_heads=2, hidden_dim=512)
    else:
        cfg.update(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                   intermediate_size=512)
    if t["kind"] == "train":
        t["recipe"]["per_device_train_batch_size"] = 2
        t["rows"] = 32
        t["doc_words"] = {"median": 20, "sigma": 0.6, "min": 4, "max": 100}
        t["warmup"] = {"min_steps": 1, "max_steps": 3, "buckets": [64]}
        t.update(sample_window=2, sampled_batches=1, mesh_positions=mesh_positions)
        cell.chips = mesh_positions
    elif t["kind"] == "ingest":
        t.update(corpus_docs=60, corpora=2, batch_size=8,
                 doc_words={"median": 30, "sigma": 0.6, "min": 4, "max": 120})
    else:
        cfg["corpus_docs"] = 20000
        idx = dict(cfg["deployment"]["index"], block_docs=1024, postings_cap=512,
                   postings_ext_cap=1024)
        cfg["deployment"] = dict(cfg["deployment"], index=idx)
        t.update(query_pool=512, warmup_calls=2, sample_queries=32)
    cell.config, cell.traffic = cfg, t
    cell.device, cell.seed = "cpu", seed
    if fault:
        cell.overrides["fault"] = fault
    cell.overrides["compute"] = compute
    return cell


@pytest.fixture
def tiny():
    return tiny_cell

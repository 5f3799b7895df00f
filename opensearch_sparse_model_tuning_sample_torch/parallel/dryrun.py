"""A multi-device dry run on the CPU: the port's counterpart of the JAX
repository's `__graft_entry__.dryrun_multichip(n)`.

    python -m opensearch_sparse_model_tuning_sample_torch.parallel.dryrun [n]

It checks the two ways the port spreads work over devices, at tiny shapes:

  1. one data-parallel `infonce` train step over `n` gloo ranks (separate
     processes with torchrun's variables and a local rendezvous; the
     launch of `core/distributed.py`): every rank must finish with a
     finite loss and the same updated weights;
  2. a doc-sharded and a query-sharded search on `make_mesh(devices=["cpu"]
     * n)`, each held to the unsharded index over the same rows.

It prints one line and raises when a rank or a check fails. It needs no
card: every process runs on the CPU.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_IDF = os.path.join(_REPO, "assets", "idf.npz")
_RANK_TIMEOUT_S = 300
_MODULE = "opensearch_sparse_model_tuning_sample_torch.parallel.dryrun"
_VOCAB = 30522  # the tiny model's (BERT uncased) vocabulary


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_step_rank(out_dir: str) -> None:
    """One rank of the data-parallel step (run in its own process)."""
    from ..core import distributed
    from ..core.config import parse_config
    from ..models import sparse_encoder as se
    from ..train.trainer import Trainer

    torch.set_num_threads(1)
    if not distributed.maybe_init_distributed("cpu", timeout_s=_RANK_TIMEOUT_S):
        raise RuntimeError("dryrun rank: no rendezvous in the environment")
    try:
        rank, world = distributed.rank(), distributed.world_size()
        model = se.build_model(arch="tiny", idf_path=_IDF, seed=0, device="cpu")
        ma, da, ta = parse_config(dict(
            arch="tiny", inf_free=True, loss_types=["infonce"], use_in_batch_negatives=True,
            flops_d_lambda=0.01, flops_d_T=10, output_dir=out_dir, max_steps=1,
            warmup_steps=1, learning_rate=1e-4, save_strategy="no", dp_size=world,
            device="cpu"))
        trainer = Trainer(model, ma, da, ta)
        # each rank's slice of the global batch (2 queries x 2 docs a rank)
        B, G, L = 2, 2, 32
        tok = model.tokenizer
        qf = tok([f"a tiny query {rank} {i}" for i in range(B)], max_length=L, pad_to=L)
        df = tok([f"a tiny document {rank} {i}" for i in range(B * G)], max_length=L, pad_to=L)
        metrics = trainer.train_step({
            "q_input_ids": qf["input_ids"], "q_attention_mask": qf["attention_mask"],
            "d_input_ids": df["input_ids"], "d_attention_mask": df["attention_mask"]})
        weights = torch.cat([p.detach().reshape(-1) for p in trainer.params])
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "world": world, "backend": distributed.backend(),
                       "loss": float(metrics["loss"]),
                       "weights_sum": float(weights.double().sum()),
                       "weights_abs_sum": float(weights.double().abs().sum())}, f)
    finally:
        distributed.destroy()


def _train_step(n: int, out_dir: str) -> float:
    """Launch n ranks of the step; returns the loss (every rank's)."""
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", _MODULE, "--rank", out_dir], cwd=_REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=_RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun_multichip({n}): rank {r} failed "
                               f"(rc={p.returncode}):\n{log[-3000:]}")
    ranks = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    if not np.isfinite(r0["loss"]):
        raise RuntimeError(f"dryrun_multichip({n}): loss {r0['loss']}")
    for r in ranks:
        if (r["world"], r["backend"]) != (n, "gloo"):
            raise RuntimeError(f"dryrun_multichip({n}): rank {r['rank']} ran at world "
                               f"{r['world']} on {r['backend']}")
        # one summed gradient and one optimizer step on every rank
        if (r["loss"], r["weights_sum"], r["weights_abs_sum"]) != (
                r0["loss"], r0["weights_sum"], r0["weights_abs_sum"]):
            raise RuntimeError(f"dryrun_multichip({n}): rank {r['rank']} disagrees with rank "
                               f"0: {r} vs {r0}")
    return r0["loss"]


def _same_hits(got, want, what: str) -> None:
    for qi, (g, w) in enumerate(zip(got, want)):
        if list(g) != list(w) or not np.allclose(list(g.values()), list(w.values()),
                                                 rtol=1e-6):
            raise RuntimeError(f"dryrun: {what} query {qi}: {g} against the unsharded {w}")


def _sharded_search(n: int, vocab: int):
    """The doc- and query-sharded searches against the unsharded index;
    returns the number of queries each answered."""
    from ..core.mesh import make_mesh
    from ..index.engine import IndexConfig, SparseIndex

    mesh = make_mesh(devices=["cpu"] * n)
    rng = np.random.default_rng(0)
    reps = np.zeros((n * 16, vocab), np.float32)
    for i in range(reps.shape[0]):
        reps[i, rng.choice(vocab, 5, replace=False)] = rng.uniform(0.5, 2.0, 5)
    ids = [str(i) for i in range(reps.shape[0])]
    counts = []
    for shard_by in ("docs", "queries"):
        cfg = IndexConfig(l_max=8, block_docs=16, query_batch=max(n, 4), shard_by=shard_by)
        single = SparseIndex(vocab, cfg, device="cpu")
        sharded = SparseIndex(vocab, cfg, mesh=mesh)
        for ix in (single, sharded):
            ix.add(ids, reps)
            ix.finalize()
        q = reps[:max(n, 4)]
        hits = sharded.search(q, k=3)
        if not all(str(i) in h for i, h in enumerate(hits)):
            raise RuntimeError(f"dryrun: a {shard_by}-sharded search missed its own doc: {hits}")
        _same_hits(hits, single.search(q, k=3), f"{shard_by}-sharded")
        counts.append(len(hits))
    return counts


def dryrun_multichip(n_devices: int) -> None:
    """The train step over `n_devices` gloo ranks, then the doc- and
    query-sharded searches on an `n_devices`-position CPU mesh; one line
    on success, an exception otherwise."""
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as out_dir:
        loss = _train_step(n_devices, out_dir)
    n_doc, n_query = _sharded_search(n_devices, _VOCAB)
    print(f"dryrun_multichip({n_devices}): train step ok over {n_devices} gloo ranks "
          f"(loss={loss:.4f}), sharded search ok ({n_doc} queries), "
          f"query-sharded search ok ({n_query} queries)")


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--rank":
        _train_step_rank(sys.argv[2])
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)

"""The port's train step over the device mesh of one process (`Trainer(mesh=)`
on `["cpu"] * 4`) against the port's one-position step on the same global
batch and against the JAX package's `Trainer(mesh=make_mesh(4))`, from the
same weights (`params_from_jax`), with dropout off (the two frameworks'
streams cannot match). Also the mesh's batch split and collectives, the
train state, and `cli.train_ir`'s `dp_size` in one process.

The recipe is tests/test_torch_dist_train.py's: `tiny`, fp32 compute, a
global batch of B 8 queries x G 2 docs at L 16, lr 1e-3 with no warm-up
over 2 steps (lr 1e-3, then 5e-4). Each of the four positions holds 2
queries and their 4 docs (with accumulation, A 2: 1 query a position in
each microbatch). The cases: infonce with in-batch negatives
(inference-free), kldiv on the dataset's scores, kldiv on the in-batch
scores of a native sparse teacher, full-forward queries with the query
FLOPS term, and infonce with accumulation.

Tolerances:
  * every replica is bit-equal to the model after every step (one copy of
    the updated parameters);
  * the first step's summed gradient, per tensor: |g - g_ref| <= rel
    |g_ref| + 1e-7 G, G the largest tensor gradient norm, rel 1e-5 against
    the one-position port step (the mesh adds four partial gradients where
    one pass adds them in another order: about 1e-6 relative in fp32) and
    1e-4 against JAX (its gradient read from Adam's first moment, (1 - b1)
    g after one step). The floor covers gradients that are 0 in exact
    arithmetic (attention key biases);
  * the loss and every metric of the first step: 1e-5 relative against the
    one-position step, 1e-4 against JAX;
  * the parameters after the 2 steps: 1e-5 absolute against the
    one-position step, 1e-4 against JAX, but for entries whose gradient is
    rounding noise, which Adam moves by up to +-lr_t whatever the noise:
    those within 2 * sum_t lr_t (the attention key biases, and no more than
    1e-3 of any other tensor's entries; see test_torch_dist_train.py).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from opensearch_sparse_model_tuning_sample_tpu.core import config as jconfig
from opensearch_sparse_model_tuning_sample_tpu.core.mesh import make_mesh as jmake_mesh
from opensearch_sparse_model_tuning_sample_tpu.models import sparse_encoder as jse
from opensearch_sparse_model_tuning_sample_tpu.train import teachers as jteachers
from opensearch_sparse_model_tuning_sample_tpu.train.trainer import Trainer as JTrainer
from opensearch_sparse_model_tuning_sample_torch.cli import train_ir
from opensearch_sparse_model_tuning_sample_torch.core import config as tconfig
from opensearch_sparse_model_tuning_sample_torch.core import mesh as tmesh
from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert
from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import load_tokenizer
from opensearch_sparse_model_tuning_sample_torch.ops import flops as tflops
from opensearch_sparse_model_tuning_sample_torch.ops.activations import special_token_mask
from opensearch_sparse_model_tuning_sample_torch.parallel import collectives
from opensearch_sparse_model_tuning_sample_torch.train import teachers as tteachers
from opensearch_sparse_model_tuning_sample_torch.train import trainer as trainer_mod
from opensearch_sparse_model_tuning_sample_torch.train.trainer import Trainer
from test_torch_dist_train import (KEY_BIAS, _adam_mu, _fp32, _port_model, _port_state,
                                   _port_teacher, assert_grads_close)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, G, L, STEPS, N = 8, 2, 16, 2, 4
LR = 1e-3
LR_SUM = LR * (1 + 0.5)  # no warm-up over 2 steps: 1e-3, then 5e-4
SCORE_SCALE = 30.0
CPU = torch.device("cpu")
CASES = {
    "infonce": dict(loss_types=["infonce"], use_in_batch_negatives=True),
    "kldiv": dict(loss_types=["kldiv"], use_in_batch_negatives=False),
    "teacher": dict(loss_types=["kldiv"], use_in_batch_negatives=True),
    "flops_q": dict(loss_types=["infonce"], use_in_batch_negatives=True, inf_free=False,
                    flops_q_lambda=0.02, flops_q_T=1),
    "accumulation": dict(loss_types=["infonce"], use_in_batch_negatives=True,
                         gradient_accumulation_steps=2),
}
# the leaves each position hands the gather a microbatch: d and q reps, plus
# the dataset's scores or the teacher's q and d reps
LEAVES = {"kldiv": 3, "teacher": 4}


def _args(mod, case, out, **over):
    raw = dict(arch="tiny", inf_free=True, flops_d_lambda=0.01, flops_d_T=1,
               learning_rate=LR, max_steps=STEPS, warmup_steps=0, save_strategy="no",
               logging_steps=1000, seed=0, output_dir=str(out), device="cpu")
    return mod.parse_config({**raw, **CASES[case], **over})


def _batch(tok, case, skewed=False):
    """The global batch: B queries, their B*G docs, and for kldiv the
    dataset's [B, G] scores, or the teacher's features of the same texts.
    `skewed` gives position 0 one-word docs and the others long ones, so the
    positions' activations differ a lot."""
    r = np.random.default_rng(7)
    queries = [f"query number {i} about topic {i % 3}" for i in range(B)]
    docs = [f"document body {i} about topic {i % 3} and {int(r.integers(0, 50))}"
            for i in range(B * G)]
    if skewed:
        per = B * G // N
        docs = ["paris" if i < per else " ".join([docs[i]] * 4) for i in range(B * G)]
    qf, df = tok(queries, max_length=L, pad_to=L), tok(docs, max_length=L, pad_to=L)
    b = {"q_input_ids": qf["input_ids"], "q_attention_mask": qf["attention_mask"],
         "d_input_ids": df["input_ids"], "d_attention_mask": df["attention_mask"]}
    if case == "kldiv":
        b["scores"] = r.normal(size=(B, G)).astype(np.float32) * 3
    if case == "teacher":
        b["teacher_q"] = [{k: qf[k] for k in ("input_ids", "attention_mask")}]
        b["teacher_d"] = [{k: df[k] for k in ("input_ids", "attention_mask")}]
    return b


@pytest.fixture(scope="module")
def jm():
    m = jse.build_model(arch="tiny", idf_path="assets/idf.npz", seed=0,
                        compute_dtype=jax.numpy.float32)
    return dataclasses.replace(m, cfg=_fp32(m.cfg))


@pytest.fixture(scope="module")
def jteacher():
    """A sparse teacher with sparse reps (its decoder bias shifted down by
    0.6, as in test_torch_dist_train.py: random weights give nearly dense
    reps whose min-max amplifies rounding 80-fold)."""
    j = jteachers.build_teacher("sparse", "tiny", seed=10)
    head = dict(j.params["mlm_head"], bias=j.params["mlm_head"]["bias"] - 0.6)
    return dataclasses.replace(j, cfg=_fp32(j.cfg), params=dict(j.params, mlm_head=head))


def _ensembles(case, jteacher):
    """JAX's and the port's ensemble of the one teacher (None for the cases
    without one)."""
    if case != "teacher":
        return None, None
    tcfg, tsd = _port_teacher(jteacher)
    port = tteachers.Teacher(
        kind="sparse", bert=tbert.from_state_dict(tcfg, tsd, CPU).requires_grad_(False),
        tokenizer=load_tokenizer(None),
        special_mask=special_token_mask(jteacher.tokenizer.special_token_ids, tcfg.vocab_size),
        pooling=jteacher.pooling)
    return (jteachers.TeacherEnsemble([jteacher], score_scale=SCORE_SCALE,
                                      use_in_batch_negatives=True),
            tteachers.TeacherEnsemble([port], score_scale=SCORE_SCALE,
                                      use_in_batch_negatives=True))


def cpu_mesh(n=N):
    return tmesh.make_mesh(devices=["cpu"] * n)


def assert_replicas_equal(trainer):
    lead = dict(trainer.model.named_parameters())
    for r in trainer.replicas:
        for k, p in r.named_parameters():
            assert torch.equal(p, lead[k]), k
        assert all(p.grad is None for p in r.parameters())


def assert_params_close(got, want, atol):
    """Every entry within `atol`, but for entries that Adam moves by up to
    +-lr_t on a gradient of rounding noise: those within 2 * sum_t lr_t
    (the attention key biases, and at most 1e-3 of another tensor's
    entries)."""
    for k, w in want.items():
        d = np.abs(np.asarray(got[k], np.float64) - w)
        assert float(d.max()) <= 2 * LR_SUM + 1e-6, (k, float(d.max()))
        if not KEY_BIAS.search(k):
            assert int((d > atol).sum()) <= 1e-3 * d.size, (k, int((d > atol).sum()), d.size)


def _train(trainer, batch):
    """STEPS steps: (first step's metrics, first step's gradients)."""
    for step in range(STEPS):
        m = {k: float(v) for k, v in trainer.train_step(batch).items()}
        if step == 0:
            m0 = m
            g0 = {k: p.grad.numpy().copy() for k, p in trainer.model.named_parameters()
                  if p.grad is not None}
        if trainer.replicas:
            assert_replicas_equal(trainer)
    return m0, g0


def _state(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_step_matches_one_position_and_jax_mesh(jm, jteacher, tmp_path, case):
    ma, da, ta = _args(tconfig, case, tmp_path)
    A = ta.gradient_accumulation_steps
    tm, cfg, _ = _port_model(jm)
    batch = _batch(tm.tokenizer, case)
    jens, tens = _ensembles(case, jteacher)

    collectives.reset_counts()
    mesh_tr = Trainer(tm, ma, da, ta, teacher_ensemble=tens, mesh=cpu_mesh())
    assert len(mesh_tr.replicas) == N - 1
    m_mesh, g_mesh = _train(mesh_tr, batch)
    assert collectives.counts() == {"all_gather_batch": 0, "all_reduce_grads": 0}
    assert collectives.mesh_counts() == {
        "mesh_gather": STEPS * A * LEAVES.get(case, 2),
        "mesh_grad_sum": STEPS, "mesh_broadcast": STEPS}
    got = _state(tm)

    one, _, _ = _port_model(jm)
    collectives.reset_counts()
    one_tr = Trainer(one, ma, da, ta, teacher_ensemble=tens)
    assert one_tr.mesh.devices == (CPU,) and not one_tr.replicas
    m_one, g_one = _train(one_tr, batch)
    assert collectives.counts() == {"all_gather_batch": 0, "all_reduce_grads": 0}
    assert collectives.mesh_counts() == {"mesh_gather": 0, "mesh_grad_sum": 0,
                                         "mesh_broadcast": 0}
    assert_grads_close(g_mesh, g_one, rel=1e-5)
    for k, v in m_one.items():
        assert m_mesh[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    assert_params_close(got, _state(one), atol=1e-5)

    jma, jda, jta = _args(jconfig, case, tmp_path)
    jt = JTrainer(jm, jma, jda, jta, teacher_ensemble=jens, mesh=jmake_mesh(N))
    for step in range(STEPS):
        jmetrics = {k: float(v) for k, v in jt.train_step(batch).items()}
        if step == 0:  # Adam's first moment after one step is (1 - b1) g
            jm0 = jmetrics
            mu = _adam_mu(jt.state.opt_state)["bert"]
            jg = {"bert": jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, mu),
                  "idf_vector": np.zeros_like(jm.params["idf_vector"])}
    want_g = _port_state(jg, cfg)
    assert_grads_close(g_mesh, {k: want_g[k] for k in g_mesh}, rel=1e-4)
    for k, v in jm0.items():
        assert m_mesh[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    assert_params_close(got, _port_state(jt.state.params, cfg), atol=1e-4)


def _sparse_student(jm):
    """The port's student with its decoder bias shifted down by 1, so that
    a doc's activation grows with its length (random weights activate
    nearly every term of any doc)."""
    tm, _, _ = _port_model(jm)
    with torch.no_grad():
        tm.bert.mlm_head.bias -= 1.0
    return tm


def test_regulariser_metrics_and_clip_norm_are_the_global_batch_s(jm, tmp_path, monkeypatch):
    """Positions whose activations differ a lot (one-word docs at position
    0, long docs elsewhere): the FLOPS term, the metrics and the clip norm
    are those of the global batch, not a mean of the positions' (the FLOPS
    term is quadratic in the docs' mean activation)."""
    norms = []
    clip = torch.nn.utils.clip_grad_norm_

    def recording_clip(params, max_norm):
        norms.append(float(clip(params, max_norm)))

    monkeypatch.setattr(torch.nn.utils, "clip_grad_norm_", recording_clip)
    ma, da, ta = _args(tconfig, "infonce", tmp_path, max_grad_norm=1e-3)
    tm, one = _sparse_student(jm), _sparse_student(jm)
    batch = _batch(tm.tokenizer, "infonce", skewed=True)
    d_reps = [trainer_mod.encode_rows(tm, part, ma)["d"].detach()
              for part in tmesh.shard_batch(cpu_mesh(), batch)]
    mesh_tr = Trainer(tm, ma, da, ta, mesh=cpu_mesh())
    m_mesh, g_mesh = _train(mesh_tr, batch)
    m_one, g_one = _train(Trainer(one, ma, da, ta), batch)

    assert len(norms) == 2 * STEPS and norms[0] > 1e-3  # the clip is active
    assert norms[0] == pytest.approx(norms[STEPS], rel=1e-5)
    assert norms[1] == pytest.approx(norms[STEPS + 1], rel=1e-5)
    for k in ("d_flops", "avg_doc_length", "nonzero_mean", "nonzero_max", "loss"):
        assert m_mesh[k] == pytest.approx(m_one[k], rel=1e-5), k
    per_pos_flops = np.mean([float(tflops.flops_value(d, G)) for d in d_reps])
    per_pos_len = np.mean([float((d > 0).sum()) / len(d) for d in d_reps])
    assert abs(per_pos_flops - m_one["d_flops"]) > 0.1 * m_one["d_flops"]
    assert m_mesh["avg_doc_length"] == pytest.approx(per_pos_len, rel=1e-6)  # a plain mean
    assert_grads_close(g_mesh, g_one, rel=1e-5)
    assert_params_close(_state(tm), _state(one), atol=1e-5)


def test_train_state_saves_the_model_and_refreshes_the_replicas(jm, tmp_path):
    ma, da, ta = _args(tconfig, "infonce", tmp_path, max_steps=4)
    tm, _, _ = _port_model(jm)
    batch = _batch(tm.tokenizer, "infonce")
    first = Trainer(tm, ma, da, ta, mesh=cpu_mesh())
    first.train_step(batch)
    first.save_train_state()
    first.train_step(batch)

    fresh, _, _ = _port_model(jm)
    again = Trainer(fresh, ma, da, ta, mesh=cpu_mesh())
    again.restore_train_state()
    assert again.step == 1
    assert_replicas_equal(again)
    again.train_step(batch)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k
    assert_replicas_equal(again)


def test_rows_split_over_the_positions_in_order_or_raise():
    tok_like = {"q": np.arange(4), "d": np.arange(8).reshape(8, 1),
                "teacher_q": [{"input_ids": np.arange(4) + 10}], "texts": tuple("abcd")}
    parts = tmesh.shard_batch(cpu_mesh(2), tok_like)
    assert [p["q"].tolist() for p in parts] == [[0, 1], [2, 3]]
    assert [p["d"].ravel().tolist() for p in parts] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert [p["teacher_q"][0]["input_ids"].tolist() for p in parts] == [[10, 11], [12, 13]]
    assert [p["texts"] for p in parts] == [("a", "b"), ("c", "d")]
    with pytest.raises(ValueError, match="do not split"):
        tmesh.shard_batch(cpu_mesh(), {"q": np.arange(6)})  # never padded


def test_mesh_collectives_gather_sum_and_broadcast_in_position_order():
    collectives.reset_counts()
    parts = [torch.full((2,), float(p), requires_grad=True) for p in range(3)]
    out = collectives.mesh_gather(parts, CPU)
    assert out.tolist() == [0, 0, 1, 1, 2, 2]
    (out * torch.arange(6.0)).sum().backward()
    assert [p.grad.tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]  # each its rows

    lead = [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2))]
    reps = [[torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2))]
            for _ in range(2)]
    lead[0].grad = torch.tensor([1.0, 2.0, 3.0])
    reps[0][0].grad = torch.tensor([10.0, 20.0, 30.0])
    reps[1][0].grad = torch.tensor([100.0, 200.0, 300.0])
    collectives.mesh_grad_sum(lead, reps)
    assert lead[0].grad.tolist() == [111, 222, 333]
    assert lead[1].grad is None  # no position gave it a gradient
    assert all(p.grad is None for r in reps for p in r)
    with torch.no_grad():
        lead[0].copy_(torch.tensor([0.1, 0.2, 0.3]))
        lead[1].copy_(torch.tensor([4.0, 5.0]))
    collectives.mesh_broadcast(lead, reps)
    assert all(torch.equal(a, b) for r in reps for a, b in zip(r, lead))
    assert collectives.counts() == {"all_gather_batch": 0, "all_reduce_grads": 0}
    assert collectives.mesh_counts() == {"mesh_gather": 1, "mesh_grad_sum": 1,
                                         "mesh_broadcast": 1}


def test_mesh_first_device_must_be_the_models(jm, tmp_path):
    ma, da, ta = _args(tconfig, "infonce", tmp_path)
    tm, _, _ = _port_model(jm)
    with pytest.raises(ValueError, match="first device"):
        Trainer(tm, ma, da, ta, mesh=tmesh.Mesh(["meta", "cpu"]))


def _train_file(path, n=24):
    import datasets

    rows = [{"query": f"query {i} about topic {i % 5}",
             "pos": f"a passage {i} on topic {i % 5}",
             "negs": [f"another passage {i + j} on {j}" for j in range(3)]} for i in range(n)]
    datasets.Dataset.from_list(rows).save_to_disk(str(path))
    return str(path)


def _cli_cfg(tmp_path, **over):
    return {"arch": "tiny", "inf_free": True, "idf_path": os.path.join(REPO, "assets", "idf.npz"),
            "max_seq_length": 16, "train_file": _train_file(tmp_path / "train"),
            "data_type": "posnegs", "loss_types": ["infonce"], "sample_num_one_query": 2,
            "use_in_batch_negatives": True, "flops_d_lambda": 0.01, "flops_d_T": 2,
            "per_device_train_batch_size": 2, "max_steps": 2, "warmup_steps": 0,
            "learning_rate": 1e-4, "logging_steps": 1, "save_strategy": "no",
            "seq_buckets": [16], "device": "cpu", "output_dir": str(tmp_path / "out"), **over}


def _one_process(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "OSSMT_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)


def test_train_cli_trains_over_the_mesh_of_dp_size_in_one_process(tmp_path, monkeypatch):
    """dp_size 2 over a two-position CPU mesh (process_mesh patched to give
    dp_size CPU positions, as the visible cards would): the loader batch is
    2 x per_device x A rows, and the step runs through the mesh."""
    _one_process(monkeypatch)
    seen = []
    monkeypatch.setattr(train_ir, "process_mesh",
                        lambda device, dp_size, world: tmesh.make_mesh(
                            dp_size, devices=[device] * 2))
    step = Trainer.train_step

    def recording_step(self, batch):
        seen.append((len(batch["q_input_ids"]), len(batch["d_input_ids"]), self.mesh.size))
        return step(self, batch)

    monkeypatch.setattr(Trainer, "train_step", recording_step)
    collectives.reset_counts()
    trainer = train_ir.main(_cli_cfg(tmp_path, dp_size=2, gradient_accumulation_steps=2))
    assert trainer.step == 2 and len(trainer.replicas) == 1
    # per_device 2 x mesh 2 x A 2 queries, each with a positive and 2 negatives
    assert seen == [(2 * 2 * 2, 2 * 2 * 2 * 3, 2)] * 2
    assert collectives.mesh_counts()["mesh_grad_sum"] == 2
    summary = json.load(open(tmp_path / "out" / "run_summary.json"))
    assert summary["mesh"] == ["cpu", "cpu"] and summary["mesh_collectives"]["mesh_broadcast"] == 2


def test_train_cli_dp_size_beyond_the_devices_raises_as_jax(tmp_path, monkeypatch):
    _one_process(monkeypatch)
    with pytest.raises(ValueError, match="dp_size 2 > available devices 1"):
        train_ir.main(_cli_cfg(tmp_path, dp_size=2))
    with pytest.raises(ValueError, match="dp_size 2 > available devices 1"):
        jmake_mesh(2, devices=jax.devices()[:1])


def test_train_cli_under_a_launch_still_needs_the_world_size(tmp_path, monkeypatch):
    _one_process(monkeypatch)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")  # no rendezvous: no group, but two ranks
    with pytest.raises(ValueError, match="one\\s+process per card"):
        train_ir.main(_cli_cfg(tmp_path, dp_size=4))


def test_yaml_dp_size_reaches_the_mesh(tmp_path, monkeypatch):
    """The dp_size of a YAML config, as a user passes it, sizes the mesh."""
    _one_process(monkeypatch)
    got = []
    monkeypatch.setattr(train_ir, "process_mesh",
                        lambda device, dp_size, world: got.append(dp_size) or tmesh.make_mesh(
                            dp_size, devices=[device] * 3))
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.dump(_cli_cfg(tmp_path, dp_size=3, max_steps=1,
                                       per_device_train_batch_size=1)))
    trainer = train_ir.main(str(path))
    assert got == [3] and trainer.mesh.size == 3 and trainer.step == 1


def test_kernel_library_builds_once_when_threads_ask_at_once(monkeypatch):
    """A backward over several cards runs one autograd thread per card, and
    each may be the first to ask for a kernel's library: it is built once,
    and no thread loads it before the build is done."""
    import threading
    import time

    from opensearch_sparse_model_tuning_sample_torch.ops import kernel_build

    builds, loaded = [], []

    def slow_build(names):
        builds.append(list(names))
        time.sleep(0.05)

    monkeypatch.setattr(kernel_build, "_libs", {})
    monkeypatch.setattr(kernel_build, "build", slow_build)
    monkeypatch.setattr(kernel_build.ctypes, "CDLL",
                        lambda path: loaded.append(len(builds)) or object())
    threads = [threading.Thread(target=kernel_build.library, args=("maxpool_head_bwd",))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert builds == [["maxpool_head_bwd"]] and loaded == [1]

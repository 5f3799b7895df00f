"""The port's data-parallel train step on two gloo processes (the CPU),
against the port's one-process run of the global batch and against the JAX
package's `Trainer(mesh=make_mesh(4))` on that batch, from the same weights
(`params_from_jax`).

The recipe is JAX `tests/test_multiprocess.py`'s worker: `tiny`, fp32
compute, a global batch of B 8 queries x G 2 docs at L 16, 3 steps, lr 1e-3
with one warm-up step; dropout off (the two frameworks' streams cannot
match, and the ranks fold their rank into the key). Each rank holds 4
queries and their docs. With accumulation (A 2) global microbatch a is the
concat over ranks of each rank's microbatch a, so the global batch fed to
the one-process runs lists [rank 0 mb 0, rank 1 mb 0, rank 0 mb 1, ...].
The cases: infonce, infonce with accumulation, kldiv on the dataset's
scores, and kldiv on the in-batch [B, B*G] scores of a sparse teacher,
whose reps each rank gathers before the scores and their min-max. One pair
of worker processes runs every case, one after another.

Tolerances:
  * the two ranks' parameters are bit-equal (one summed gradient, one
    optimizer on each);
  * the first step's gradient, after the all-reduce, per tensor:
    |g - g_ref| <= rel |g_ref| + 1e-7 G, G the largest tensor gradient
    norm, against the one-process port run (rel 1e-5) and against JAX
    (rel 1e-4; its gradient is read from Adam's first moment, which after
    one step is (1 - b1) g). The floor covers a gradient that is 0 in exact
    arithmetic (an attention key bias: softmax ignores a per-row constant),
    which holds only rounding noise. A gradient off by the world size (a
    mean where a sum belongs) misses by 50%;
  * the parameters after the steps, against the one-process port run:
    1e-5 absolute; against JAX: 1e-4. Adam's normalised update moves an
    entry whose gradient is rounding noise by up to +-lr_t whatever the
    noise (see test_torch_train_step.py), so such entries are held to
    2 * sum_t lr_t instead: the attention key biases, and no more than
    1e-3 of any other tensor's entries (see assert_params_close).
"""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from opensearch_sparse_model_tuning_sample_tpu.core import config as jconfig
from opensearch_sparse_model_tuning_sample_tpu.core.mesh import make_mesh
from opensearch_sparse_model_tuning_sample_tpu.models import sparse_encoder as jse
from opensearch_sparse_model_tuning_sample_tpu.train import teachers as jteachers
from opensearch_sparse_model_tuning_sample_tpu.train.trainer import Trainer as JTrainer
from opensearch_sparse_model_tuning_sample_torch.core import config as tconfig
from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert
from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
from opensearch_sparse_model_tuning_sample_torch.models.convert import params_from_jax
from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import load_tokenizer
from opensearch_sparse_model_tuning_sample_torch.ops.activations import special_token_mask
from opensearch_sparse_model_tuning_sample_torch.train import teachers as tteachers
from opensearch_sparse_model_tuning_sample_torch.train.trainer import Trainer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, G, L, STEPS, WORLD = 8, 2, 16, 3, 2
LR = 1e-3
LR_SUM = LR * (0 + 1 + 0.5)  # warm-up 1 of 3: lr(0) = 0, then 1e-3, 5e-4
SCORE_SCALE = 30.0
CASES = {
    "infonce": dict(loss_types=["infonce"], use_in_batch_negatives=True),
    "accumulation": dict(loss_types=["infonce"], use_in_batch_negatives=True,
                         gradient_accumulation_steps=2),
    "kldiv": dict(loss_types=["kldiv"], use_in_batch_negatives=False),
    "teacher": dict(loss_types=["kldiv"], use_in_batch_negatives=True),
}
KEY_BIAS = re.compile(r"attention\.key\.bias$")

WORKER = textwrap.dedent("""
    import json, os, sys
    import torch
    torch.set_num_threads(1)
    from opensearch_sparse_model_tuning_sample_torch.core import config, distributed
    from opensearch_sparse_model_tuning_sample_torch.models import bert, sparse_encoder as se
    from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import load_tokenizer
    from opensearch_sparse_model_tuning_sample_torch.parallel import collectives
    from opensearch_sparse_model_tuning_sample_torch.train import teachers
    from opensearch_sparse_model_tuning_sample_torch.train.trainer import Trainer

    out = sys.argv[1]
    cpu = torch.device("cpu")
    assert distributed.maybe_init_distributed("cpu", timeout_s=60)
    rank, world = distributed.rank(), distributed.world_size()
    blob = torch.load(os.path.join(out, "init.pt"), weights_only=False)
    tok = load_tokenizer(None)


    def encoder(cfg, sd):
        return bert.from_state_dict(cfg, {k[5:]: v for k, v in sd.items()
                                          if k.startswith("bert.")}, cpu)


    for case in sys.argv[2:]:
        d = os.path.join(out, case)
        model = se.SparseEncoderModel(blob["cfg"], encoder(blob["cfg"], blob["sd"]),
                                      blob["sd"]["idf_vector"], tok)
        ma, da, ta = config.parse_config(json.load(open(os.path.join(d, "args.json"))))
        ensemble = None
        if case == "teacher":
            t = blob["teacher"]
            ensemble = teachers.TeacherEnsemble(
                [teachers.Teacher(
                    kind="sparse",
                    bert=bert.from_state_dict(t["cfg"], t["sd"], cpu).requires_grad_(False),
                    tokenizer=tok, special_mask=t["special_mask"], pooling=t["pooling"])],
                score_scale=t["score_scale"], use_in_batch_negatives=True)
        batch = torch.load(os.path.join(d, f"local{rank}.pt"), weights_only=False)
        collectives.reset_counts()
        trainer = Trainer(model, ma, da, ta, teacher_ensemble=ensemble)
        for step in range(%(steps)d):
            m = trainer.train_step(batch)
            if step == 0:  # the summed gradient (lr(0) = 0: the weights have not moved)
                torch.save({k: p.grad for k, p in model.named_parameters() if p.grad is not None},
                           os.path.join(d, f"grad{rank}.pt"))
        torch.save(model.state_dict(), os.path.join(d, f"rank{rank}.pt"))
        with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
            json.dump({"metrics": {k: float(v) for k, v in m.items()},
                       "backend": distributed.backend(), "world": world,
                       "counts": collectives.counts()}, f)
    distributed.destroy()
""") % {"steps": STEPS}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(script, args, world=WORLD, timeout=120):
    """`world` processes of `script` with torchrun's variables and a gloo
    rendezvous on a free local port; every rank must exit 0 in time."""
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", script, *args], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o[-3000:]}"
    return outs


def _args(mod, case, out):
    raw = dict(arch="tiny", inf_free=True, flops_d_lambda=0.01, flops_d_T=10,
               learning_rate=LR, max_steps=STEPS, warmup_steps=1, save_strategy="no",
               logging_steps=1000, seed=0, output_dir=out, device="cpu", **CASES[case])
    return raw, mod.parse_config(dict(raw))


def _fp32(cfg):
    return dataclasses.replace(cfg, compute_dtype=jnp.float32, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)


def _port_model(jm):
    cfg = tbert.BertConfig(**{
        f.name: getattr(jm.cfg, f.name) for f in dataclasses.fields(tbert.BertConfig)
        if f.name not in ("param_dtype", "compute_dtype")
    }, compute_dtype=torch.float32)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), cfg)
    bert = tbert.from_state_dict(
        cfg, {k[len("bert."):]: v for k, v in sd.items() if k.startswith("bert.")},
        torch.device("cpu"))
    return tse.SparseEncoderModel(cfg, bert, sd["idf_vector"], load_tokenizer(None)), cfg, sd


def _port_teacher(j):
    """The JAX sparse teacher's weights in the port: (config, state dict)."""
    cfg = tbert.config_from_preset("tiny", vocab_size=j.cfg.vocab_size,
                                   compute_dtype=torch.float32)
    return cfg, params_from_jax(jax.tree_util.tree_map(np.asarray, j.params), cfg)


def _local_batches(tok, case):
    """Each rank's loader batch: its 4 queries, their 8 docs, and for kldiv
    the dataset's [4, G] scores, or the teacher's features of the same
    texts."""
    r = np.random.default_rng(7)
    queries = [f"query number {i} about topic {i % 3}" for i in range(B)]
    docs = [f"document body {i} about topic {i % 3} and {int(r.integers(0, 50))}"
            for i in range(B * G)]
    scores = r.normal(size=(B, G)).astype(np.float32) * 3
    lb = B // WORLD
    out = []
    for rank in range(WORLD):
        qf = tok(queries[rank * lb:(rank + 1) * lb], max_length=L, pad_to=L)
        df = tok(docs[rank * lb * G:(rank + 1) * lb * G], max_length=L, pad_to=L)
        b = {"q_input_ids": qf["input_ids"], "q_attention_mask": qf["attention_mask"],
             "d_input_ids": df["input_ids"], "d_attention_mask": df["attention_mask"]}
        if case == "kldiv":
            b["scores"] = scores[rank * lb:(rank + 1) * lb]
        if case == "teacher":
            b["teacher_q"] = [{k: qf[k] for k in ("input_ids", "attention_mask")}]
            b["teacher_d"] = [{k: df[k] for k in ("input_ids", "attention_mask")}]
        out.append(b)
    return out


def global_batch(local, A):
    """The one-process batch whose microbatch a is the concat over ranks of
    each rank's microbatch a (nested teacher features alike)."""
    def cat(xs):
        if isinstance(xs[0], dict):
            return {k: cat([x[k] for x in xs]) for k in xs[0]}
        if isinstance(xs[0], list):
            return [cat([x[i] for x in xs]) for i in range(len(xs[0]))]
        n = len(xs[0]) // A
        return np.concatenate([x[a * n:(a + 1) * n] for a in range(A) for x in xs])

    return cat(local)


def _port_state(tree, cfg):
    return {k: v.numpy() for k, v in
            params_from_jax(jax.tree_util.tree_map(np.asarray, tree), cfg).items()}


def _adam_mu(state):
    """The first moment of the optimizer's AdamW over the encoder (None if
    `state` holds none)."""
    if isinstance(state, optax.ScaleByAdamState):
        return state.mu
    if isinstance(state, dict):
        state = tuple(state.values())
    for s in state if isinstance(state, tuple) else ():
        mu = _adam_mu(s)
        if mu is not None:
            return mu
    return None


def assert_grads_close(got, want, rel):
    floor = 1e-7 * max(np.linalg.norm(w) for w in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        err = np.linalg.norm(np.asarray(got[k], np.float64) - w)
        assert err <= rel * np.linalg.norm(w) + floor, (k, err, np.linalg.norm(w))


def assert_params_close(got, want, atol):
    """Every entry within `atol`, but for entries that Adam moves by up to
    +-lr_t on a gradient of rounding noise: those within 2 * sum_t lr_t.
    They are the attention key biases, and within a tensor at most 1e-3 of
    its entries (a vocabulary row of the tied decoder whose max-pooled
    logit sits at a tie between positions, or at the relu's kink, in a
    later step: a rounding difference picks the other side, and its
    gradient jumps). A tensor computed wrong moves more of its entries."""
    for k, w in want.items():
        d = np.abs(np.asarray(got[k], np.float64) - w)
        assert float(d.max()) <= 2 * LR_SUM + 1e-6, (k, float(d.max()))
        if not KEY_BIAS.search(k):
            assert int((d > atol).sum()) <= 1e-3 * d.size, (k, int((d > atol).sum()), d.size)


@pytest.fixture(scope="module")
def jm():
    m = jse.build_model(arch="tiny", idf_path="assets/idf.npz", seed=0,
                        compute_dtype=jnp.float32)
    return dataclasses.replace(m, cfg=_fp32(m.cfg))


@pytest.fixture(scope="module")
def jteacher():
    """A sparse teacher whose reps are sparse, as a trained one's are: its
    decoder bias shifted down by 0.6 leaves about 1 000 of the 30 522 terms
    nonzero (random weights leave 29 000, and scores so large and so close
    that the min-max amplifies their rounding 80-fold)."""
    j = jteachers.build_teacher("sparse", "tiny", seed=10)
    head = dict(j.params["mlm_head"], bias=j.params["mlm_head"]["bias"] - 0.6)
    return dataclasses.replace(j, cfg=_fp32(j.cfg), params=dict(j.params, mlm_head=head))


@pytest.fixture(scope="module")
def two_ranks(jm, jteacher, tmp_path_factory):
    """Every case's inputs, and one pair of gloo workers that trains them
    all; returns the directory of their outputs."""
    out = str(tmp_path_factory.mktemp("dist_train"))
    tm, cfg, sd = _port_model(jm)
    tcfg, tsd = _port_teacher(jteacher)
    teacher = {"cfg": tcfg, "sd": tsd,
               "special_mask": special_token_mask(jteacher.tokenizer.special_token_ids,
                                                  tcfg.vocab_size),
               "pooling": jteacher.pooling, "score_scale": SCORE_SCALE}
    torch.save({"cfg": cfg, "sd": sd, "teacher": teacher}, os.path.join(out, "init.pt"))
    for case in CASES:
        d = os.path.join(out, case)
        os.makedirs(d)
        raw, _ = _args(tconfig, case, d)
        json.dump(raw, open(os.path.join(d, "args.json"), "w"))
        for r, b in enumerate(_local_batches(tm.tokenizer, case)):
            torch.save(b, os.path.join(d, f"local{r}.pt"))
    spawn(WORKER, [out, *CASES], timeout=240)
    return out


def _ensembles(case, jteacher):
    """JAX's and the port's ensemble of the one teacher (None for the cases
    without one)."""
    if case != "teacher":
        return None, None
    tcfg, tsd = _port_teacher(jteacher)
    port = tteachers.Teacher(
        kind="sparse",
        bert=tbert.from_state_dict(tcfg, tsd, torch.device("cpu")).requires_grad_(False),
        tokenizer=load_tokenizer(None),
        special_mask=special_token_mask(jteacher.tokenizer.special_token_ids, tcfg.vocab_size),
        pooling=jteacher.pooling)
    return (jteachers.TeacherEnsemble([jteacher], score_scale=SCORE_SCALE,
                                      use_in_batch_negatives=True),
            tteachers.TeacherEnsemble([port], score_scale=SCORE_SCALE,
                                      use_in_batch_negatives=True))


@pytest.mark.parametrize("case", list(CASES))
def test_two_gloo_ranks_match_one_process_and_jax_mesh(jm, jteacher, two_ranks, case):
    out = os.path.join(two_ranks, case)
    tm, cfg, _ = _port_model(jm)
    _, (ma, da, ta) = _args(tconfig, case, out)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(WORLD)]
    for k in ranks[0]:
        assert torch.equal(ranks[0][k], ranks[1][k]), k  # replicated state stays in sync
    grads = [torch.load(os.path.join(out, f"grad{r}.pt")) for r in range(WORLD)]
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k  # one summed gradient on every rank
    info = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(WORLD)]
    assert info[0]["metrics"] == info[1]["metrics"]  # the global batch's loss and metrics
    assert info[0]["backend"] == "gloo" and info[0]["world"] == WORLD
    A = ta.gradient_accumulation_steps
    # q and d (and the dataset scores, or the teacher's q and d reps) gathered
    # per microbatch, one all-reduce a step
    per_mb = {"kldiv": 3, "teacher": 4}.get(case, 2)
    assert info[0]["counts"] == {"all_gather_batch": STEPS * A * per_mb,
                                 "all_reduce_grads": STEPS}

    batch = global_batch([torch.load(os.path.join(out, f"local{r}.pt"), weights_only=False)
                          for r in range(WORLD)], A)
    jens, tens = _ensembles(case, jteacher)
    one = Trainer(tm, ma, da, ta, teacher_ensemble=tens)
    for step in range(STEPS):
        m1 = one.train_step(batch)
        if step == 0:
            g1 = {k: p.grad.numpy().copy() for k, p in tm.named_parameters()
                  if p.grad is not None}
    got_g = {k: v.numpy() for k, v in grads[0].items()}
    assert_grads_close(got_g, g1, rel=1e-5)
    assert float(m1["loss"]) == pytest.approx(info[0]["metrics"]["loss"], rel=1e-5)
    assert float(m1["avg_doc_length"]) == pytest.approx(info[0]["metrics"]["avg_doc_length"],
                                                        rel=1e-6)
    got = {k: v.numpy() for k, v in ranks[0].items()}
    assert_params_close(got, {k: v.detach().numpy() for k, v in tm.state_dict().items()},
                        atol=1e-5)

    _, (jma, jda, jta) = _args(jconfig, case, out)
    jt = JTrainer(jm, jma, jda, jta, teacher_ensemble=jens, mesh=make_mesh(4))
    for step in range(STEPS):
        jm_metrics = jt.train_step(batch)
        if step == 0:  # Adam's first moment after one step is (1 - b1) g
            mu = _adam_mu(jt.state.opt_state)["bert"]
            jg = {"bert": jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, mu),
                  "idf_vector": np.zeros_like(jm.params["idf_vector"])}
    want_g = _port_state(jg, cfg)
    assert_grads_close(got_g, {k: want_g[k] for k in got_g}, rel=1e-4)
    assert float(jm_metrics["loss"]) == pytest.approx(info[0]["metrics"]["loss"], rel=1e-4)
    assert_params_close(got, _port_state(jt.state.params, cfg), atol=1e-4)

"""Knowledge distillation in the port's train step against the JAX package's
`Trainer`, from the same weights (`params_from_jax`) on the same batches:
the `tiny` student with inference-free queries, kldiv on the scores of a
teacher ensemble computed inside the step, the FLOPS ramp, AdamW with
warm-up, dropout off, fp32 compute (students and teachers). The batch is
the port's collator output, fed to both trainers.

  * two sparse teachers (the kd recipe's ensemble), in-batch negatives:
    three steps, the student held to JAX's after each;
  * a sparse and a host (transformers) teacher, grouped, with gradient
    accumulation 2, so the teachers' nested features (token ids and raw
    texts) are split with the student's.

Tolerances (fp32, both sides sum in another order): the loss at every
step 1e-4 relative; the student's parameters after every step as
tests/test_torch_train_step.py holds them (every entry within 2 sum_t lr_t,
all but 1e-3 of them within 1e-5); the teachers' parameters bit-equal to
what they were before the steps.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from opensearch_sparse_model_tuning_sample_tpu.core import config as jconfig
from opensearch_sparse_model_tuning_sample_tpu.core.mesh import make_mesh
from opensearch_sparse_model_tuning_sample_tpu.models import sparse_encoder as jse
from opensearch_sparse_model_tuning_sample_tpu.train import teachers as jt
from opensearch_sparse_model_tuning_sample_tpu.train.trainer import Trainer as JTrainer
from opensearch_sparse_model_tuning_sample_torch.core import config as tconfig
from opensearch_sparse_model_tuning_sample_torch.data.collator import build_collator
from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert
from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
from opensearch_sparse_model_tuning_sample_torch.models.convert import params_from_jax
from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import load_tokenizer
from opensearch_sparse_model_tuning_sample_torch.ops.activations import special_token_mask
from opensearch_sparse_model_tuning_sample_torch.train import teachers as tt
from opensearch_sparse_model_tuning_sample_torch.train.trainer import Trainer

torch.set_num_threads(2)
CPU = torch.device("cpu")

WORDS = ("sparse retrieval index query document token paris france learning model "
         "tensor attention layer inverted posting score rank bert encoder").split()
LR, WARMUP, MAX_STEPS = 1e-3, 2, 20


def _args(mod, **over):
    ma = mod.ModelArguments(inf_free=True, arch="tiny")
    da = mod.DataArguments(loss_types=["kldiv"], flops_d_lambda=0.01, flops_d_T=10)
    ta = mod.TrainingArguments(output_dir="/unused", max_steps=MAX_STEPS, warmup_steps=WARMUP,
                               learning_rate=LR, logging_steps=1000, save_strategy="no", seed=0)
    for k, v in over.items():
        for a in (ma, da, ta):
            if hasattr(a, k):
                setattr(a, k, v)
    return ma, da, ta


def _fp32(cfg):
    return dataclasses.replace(cfg, compute_dtype=jnp.float32, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module")
def jm32():
    m = jse.build_model(arch="tiny", idf_path="assets/idf.npz", seed=0,
                        compute_dtype=jnp.float32)
    return dataclasses.replace(m, cfg=_fp32(m.cfg))


def _port_model(jm):
    cfg = tbert.BertConfig(**{f.name: getattr(jm.cfg, f.name) for f in dataclasses.fields(tbert.BertConfig)
                              if f.name not in ("param_dtype", "compute_dtype")},
                           compute_dtype=torch.float32)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), cfg)
    bert = tbert.from_state_dict(cfg, {k[5:]: v for k, v in sd.items() if k.startswith("bert.")},
                                 CPU)
    return tse.SparseEncoderModel(cfg, bert, sd["idf_vector"], load_tokenizer(None))


def _port_teacher(j):
    cfg = tbert.config_from_preset("tiny", vocab_size=j.cfg.vocab_size, compute_dtype=torch.float32)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, j.params), cfg)
    smask = (special_token_mask(j.tokenizer.special_token_ids, cfg.vocab_size)
             if j.kind == "sparse" else None)
    return tt.Teacher(kind=j.kind, bert=tbert.from_state_dict(cfg, sd, CPU).requires_grad_(False),
                      tokenizer=j.tokenizer, special_mask=smask, pooling=j.pooling)


def _sparse_teachers(n):
    js = [jt.build_teacher("sparse", "tiny", seed=10 + i) for i in range(n)]
    js = [dataclasses.replace(j, cfg=_fp32(j.cfg)) for j in js]
    return js, [_port_teacher(j) for j in js]


@pytest.fixture(scope="module")
def electra_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("electra"))
    with open(f"{d}/vocab.txt", "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS) + "\n")
    cfg = transformers.ElectraConfig(vocab_size=len(WORDS) + 5, embedding_size=16,
                                     hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                                     intermediate_size=32, max_position_embeddings=64)
    torch.manual_seed(2)
    transformers.ElectraModel(cfg).save_pretrained(d)
    transformers.BertTokenizerFast(vocab_file=f"{d}/vocab.txt").save_pretrained(d)
    return d


def _batches(tens, tok, n, seed, B=4, G=2):
    collator = build_collator("posnegs", tok, 64, seq_buckets=[16, 32, 64],
                              teacher_ensemble=tens)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rows = [(" ".join(rng.choice(WORDS, 3)),
                 " ".join(rng.choice(WORDS, int(rng.integers(3, 20)))),
                 [" ".join(rng.choice(WORDS, int(rng.integers(3, 20)))) for _ in range(G - 1)])
                for _ in range(B)]
        out.append(collator(rows))
    return out


def _lr_sum(n_steps):
    return LR * sum(s / WARMUP if s < WARMUP else (MAX_STEPS - s) / (MAX_STEPS - WARMUP)
                    for s in range(n_steps))


def _check_student(jtr, ttr, n_steps):
    atol = 2 * _lr_sum(n_steps) + 1e-6
    want = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtr.state.params), ttr.model.cfg).items()}
    got = ttr.model.state_dict()
    n_far = n_all = 0
    for k, w in want.items():
        d = np.abs(got[k].numpy() - w)
        assert float(d.max()) <= atol, (k, float(d.max()), atol)
        n_far += int((d > 1e-5).sum())
        n_all += d.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)


def _run(jm, jteachers, tteachers, batches, in_batch, **over):
    jens = jt.TeacherEnsemble(jteachers, score_scale=30.0, use_in_batch_negatives=in_batch)
    tens = tt.TeacherEnsemble(tteachers, score_scale=30.0, use_in_batch_negatives=in_batch)
    tm = _port_model(jm)
    jtr = JTrainer(jm, *_args(jconfig, use_in_batch_negatives=in_batch, **over),
                   teacher_ensemble=jens, mesh=make_mesh(1))
    ttr = Trainer(tm, *_args(tconfig, use_in_batch_negatives=in_batch, **over),
                  teacher_ensemble=tens)
    before = [{k: v.clone() for k, v in t.bert.state_dict().items()}
              for t in tteachers if t.bert is not None]
    jbefore = [jax.tree_util.tree_map(np.array, j.params) for j in jteachers if j.params is not None]
    for step, b in enumerate(batches):
        jl, tl = float(jtr.train_step(b)["loss"]), float(ttr.train_step(b)["loss"])
        assert np.isfinite(tl) and tl == pytest.approx(jl, rel=1e-4), step
        _check_student(jtr, ttr, step + 1)
    # the teachers: untouched, and outside the optimizer's parameters
    owned = {id(p) for p in ttr.params}
    for t, sd in zip([t for t in tteachers if t.bert is not None], before):
        for k, v in t.bert.state_dict().items():
            assert torch.equal(v, sd[k]), k
        assert not any(id(p) in owned for p in t.bert.parameters())
    for j, p in zip([j for j in jteachers if j.params is not None], jbefore):
        jax.tree_util.tree_map(np.testing.assert_array_equal, p,
                               jax.tree_util.tree_map(np.asarray, j.params))
    return ttr


def test_kd_steps_with_two_sparse_teachers_match_jax(jm32, tmp_path):
    """Three steps; the student is held to JAX's after one step and after
    each of the others."""
    js, ts = _sparse_teachers(2)
    tok = load_tokenizer(None)
    batches = _batches(tt.TeacherEnsemble(ts), tok, 3, seed=3)
    assert len(batches[0]["teacher_q"]) == 2
    ttr = _run(jm32, js, ts, batches, in_batch=True)
    assert ttr.step == 3
    # neither the train state nor a checkpoint holds a teacher
    ttr.args.output_dir = str(tmp_path)
    ttr.save_train_state()
    state = torch.load(os.path.join(tmp_path, "train_state", "state.pt"), weights_only=True)
    assert sorted(state["model"]) == sorted(ttr.model.state_dict())
    assert sum(len(g["params"]) for g in state["optimizer"]["param_groups"]) == len(ttr.params)


def test_kd_accumulation_with_a_host_teacher_matches_jax(jm32, electra_dir):
    """Gradient accumulation 2 over a sparse and a host teacher, grouped:
    each microbatch's teacher ids, texts and the host's embeddings follow
    its queries."""
    js, ts = _sparse_teachers(1)
    jh = jt.build_teacher("dense", electra_dir, pooling="mean")
    th = tt.build_teacher("dense", electra_dir, pooling="mean", device="cpu")
    assert jh.kind == th.kind == "hf"
    tok = load_tokenizer(None)
    batches = _batches(tt.TeacherEnsemble(ts + [th]), tok, 2, seed=7)
    assert isinstance(batches[0]["teacher_d"][1]["texts"], tuple)
    ttr = _run(jm32, js + [jh], ts + [th], batches, in_batch=False,
               gradient_accumulation_steps=2)
    assert ttr.accum_steps == 2 and ttr.step == 2

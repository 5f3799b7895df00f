"""The port's train step against the JAX package's, from the same weights
(`params_from_jax`) on the same batches: the `tiny` arch, Lq 16, Ld 24,
InfoNCE with in-batch negatives + the FLOPS ramp, AdamW with warm-up, the
dropout probabilities 0 (the two RNG streams cannot match), fp32 compute.

Tolerances, fp32 (both sides sum in another order):
  * step-0 gradients: per tensor, |g_port - g_jax| <= 1e-4 |g_jax| + 1e-7 G,
    G the largest tensor gradient norm: the floor covers a gradient that is
    0 in exact arithmetic (an attention key bias: softmax ignores a per-row
    constant), which holds only rounding noise on both sides;
  * the loss at every step: 1e-4 relative;
  * the parameters after the steps: absolute, from the learning rate.
    Adam's normalised update m_hat / (sqrt(v_hat) + eps) is about +-1 for
    any gradient well above eps, however small: an entry whose gradient is
    rounding noise (say 1e-9 on one side, -1e-9 on the other) moves by up
    to lr_t in opposite directions. So an entry may differ by up to
    2 * sum_t lr_t; all but a few entries agree to 1e-5.
bf16 compute rounds at other places in the two frameworks (a bf16 step per
layer boundary, forward and backward): its step-0 loss is held to 1e-2
relative and its gradients to 1e-1 per tensor, with the floor at 1e-4 G.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_sparse_model_tuning_sample_tpu.core import config as jconfig
from opensearch_sparse_model_tuning_sample_tpu.core.mesh import make_mesh
from opensearch_sparse_model_tuning_sample_tpu.models import sparse_encoder as jse
from opensearch_sparse_model_tuning_sample_tpu.ops import flops as jflops
from opensearch_sparse_model_tuning_sample_tpu.ops.losses import build_loss_specs as jspecs
from opensearch_sparse_model_tuning_sample_tpu.train.trainer import Trainer as JTrainer
from opensearch_sparse_model_tuning_sample_torch.core import config as tconfig
from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert
from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
from opensearch_sparse_model_tuning_sample_torch.models.convert import params_from_jax
from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import load_tokenizer
from opensearch_sparse_model_tuning_sample_torch.ops.losses import build_loss_specs
from opensearch_sparse_model_tuning_sample_torch.train.trainer import Trainer, train_loss

torch.set_num_threads(2)

TEXTS = [
    "the capital of france is paris",
    "machine learning on tensor processing units",
    "sparse retrieval uses inverted indexes",
    "bert computes contextual token representations",
    "the eiffel tower is in paris france",
    "tpus have a systolic matrix multiply unit",
    "an inverted index maps terms to documents",
    "transformers use self attention layers",
]
LR, WARMUP, MAX_STEPS = 1e-3, 2, 20


def _batch(tok, seed, B=4, G=3, Lq=16, Ld=24):
    r = np.random.default_rng(seed)
    qs = [TEXTS[i] for i in r.integers(0, len(TEXTS), B)]
    docs = [" ".join(r.choice(TEXTS, 2)) for _ in range(B * G)]
    qf, df = tok(qs, max_length=Lq, pad_to=Lq), tok(docs, max_length=Ld, pad_to=Ld)
    return {"q_input_ids": qf["input_ids"], "q_attention_mask": qf["attention_mask"],
            "d_input_ids": df["input_ids"], "d_attention_mask": df["attention_mask"]}


def _args(mod, **over):
    ma = mod.ModelArguments(inf_free=True, arch="tiny")
    da = mod.DataArguments(loss_types=["infonce"], use_in_batch_negatives=True,
                           flops_d_lambda=0.01, flops_d_T=10)
    ta = mod.TrainingArguments(output_dir="/unused", max_steps=MAX_STEPS, warmup_steps=WARMUP,
                               learning_rate=LR, logging_steps=1000, save_strategy="no", seed=0)
    for k, v in over.items():
        for a in (ma, da, ta):
            if hasattr(a, k):
                setattr(a, k, v)
    return ma, da, ta


def _jax_model(compute_dtype):
    m = jse.build_model(arch="tiny", idf_path="assets/idf.npz", seed=0,
                        compute_dtype=compute_dtype)
    cfg = dataclasses.replace(m.cfg, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return dataclasses.replace(m, cfg=cfg)


def _port_model(jm, compute_dtype, idf_requires_grad=False):
    cfg = tbert.BertConfig(**{
        f.name: getattr(jm.cfg, f.name) for f in dataclasses.fields(tbert.BertConfig)
        if f.name not in ("param_dtype", "compute_dtype")
    }, compute_dtype=compute_dtype)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), cfg)
    bert = tbert.from_state_dict(
        cfg, {k[len("bert."):]: v for k, v in sd.items() if k.startswith("bert.")},
        torch.device("cpu"))
    return tse.SparseEncoderModel(cfg, bert, sd["idf_vector"], load_tokenizer(None),
                                  idf_requires_grad=idf_requires_grad)


@pytest.fixture(scope="module")
def jm32():
    return _jax_model(jnp.float32)


def _port_state(tree, cfg):
    """A JAX tree (params or grads) in the port's state-dict naming."""
    return {k: v.numpy() for k, v in
            params_from_jax(jax.tree_util.tree_map(np.asarray, tree), cfg).items()}


def _jax_grads(jm, batch, step=0):
    """jax.grad of the JAX train step's loss (trainer.make_train_step's
    loss_fn, inference-free queries, dropout off)."""
    _, da, _ = _args(jconfig)
    specs = jspecs(da)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        d_rep = jse.encode_doc(params, jm.cfg, jb["d_input_ids"], jb["d_attention_mask"])
        q_rep = jse.encode_query_inf_free(params, jm.cfg, jb["q_input_ids"],
                                          jnp.asarray(jm.special_mask))
        d_flops = jflops.flops_value(d_rep, d_rep.shape[0] // q_rep.shape[0])
        lam = jflops.get_lambda(jnp.asarray(step), da.flops_d_lambda, da.flops_d_T)
        return sum(s(q_rep, d_rep) for s in specs) + d_flops * lam

    loss, grads = jax.value_and_grad(loss_fn)(jm.params)
    return float(loss), grads


def _port_grads(tm, batch):
    ma, da, _ = _args(tconfig)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tm.zero_grad(set_to_none=True)
    loss, _ = train_loss(tm, tb, 0, build_loss_specs(da), ma, da, dropout_key=(0, 0, 0))
    loss.backward()
    return loss.item(), {k: p.grad for k, p in tm.named_parameters() if p.grad is not None}




@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step0_gradients_match_jax(dtype, jm32):
    jm = jm32 if dtype == "float32" else _jax_model(jnp.bfloat16)
    tm = _port_model(jm, getattr(torch, dtype))
    batch = _batch(tm.tokenizer, seed=0)
    jl, jg = _jax_grads(jm, batch)
    tl, tg = _port_grads(tm, batch)
    loss_tol, grad_tol, floor = (1e-4, 1e-4, 1e-7) if dtype == "float32" else (1e-2, 1e-1, 1e-4)
    assert tl == pytest.approx(jl, rel=loss_tol)
    want = _port_state(jg, tm.cfg)
    assert set(tg) == {k for k in want if k != "idf_vector"}  # the frozen IDF has none
    floor *= max(np.linalg.norm(w) for w in want.values())
    for k, g in tg.items():
        err = np.linalg.norm(g.float().numpy() - want[k])
        assert err <= grad_tol * np.linalg.norm(want[k]) + floor, (k, err)


def _run_both(jm, tm, batches, **over):
    jt = JTrainer(jm, *_args(jconfig, **over), mesh=make_mesh(1))
    tt = Trainer(tm, *_args(tconfig, **over))
    losses = []
    for b in batches:
        jmet = jt.train_step(b)
        tmet = tt.train_step(b)
        losses.append((float(tmet["loss"]), float(jmet["loss"])))
    return jt, tt, losses


def _lr_sum(n_steps, lr=LR):
    f = [s / WARMUP if s < WARMUP else (MAX_STEPS - s) / (MAX_STEPS - WARMUP)
         for s in range(n_steps)]
    return lr * sum(f)


def _check_params(jt, tt, n_steps, lr_sum=None):
    """Every entry within 2 * sum_t lr_t (Adam's +-lr move of a gradient that
    is rounding noise); all but 1e-3 of the entries within 1e-5."""
    atol = 2 * (lr_sum if lr_sum is not None else _lr_sum(n_steps)) + 1e-6
    want = _port_state(jt.state.params, tt.model.cfg)
    got = tt.model.state_dict()
    n_far = n_all = 0
    for k, w in want.items():
        d = np.abs(got[k].numpy() - w)
        assert float(d.max()) <= atol, (k, float(d.max()), atol)
        n_far += int((d > 1e-5).sum())
        n_all += d.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)


def test_five_steps_match_jax(jm32):
    tm = _port_model(jm32, torch.float32)
    batches = [_batch(tm.tokenizer, seed=s) for s in range(5)]
    jt, tt, losses = _run_both(jm32, tm, batches)
    for step, (t, j) in enumerate(losses):
        assert t == pytest.approx(j, rel=1e-4), step
    assert tt.step == 5 and int(jt.state.step) == 5
    assert float(tt.loss_ma) == pytest.approx(float(jt.state.loss_ma), rel=1e-4)
    _check_params(jt, tt, 5)


def test_frozen_idf_stays_outside_the_clip_norm(jm32):
    """A small max_grad_norm clips every step. JAX zeroes the frozen IDF's
    gradient before its global-norm clip; the port keeps the IDF out of the
    optimizer. Were it counted, the clip scale and so every update would
    differ."""
    tm = _port_model(jm32, torch.float32)
    idf0 = tm.idf_vector.detach().clone()
    batches = [_batch(tm.tokenizer, seed=10 + s) for s in range(4)]
    jt, tt, losses = _run_both(jm32, tm, batches, max_grad_norm=0.05)
    for t, j in losses:
        assert t == pytest.approx(j, rel=1e-4)
    assert torch.equal(tm.idf_vector.detach(), idf0)
    assert not tm.idf_vector.requires_grad
    assert all(p is not tm.idf_vector for g in tt.optimizer.param_groups for p in g["params"])
    _check_params(jt, tt, 4)


def test_idf_lr_group_matches_jax(jm32):
    """A trainable IDF in its own group at idf_lr, inside the clip norm."""
    jm = dataclasses.replace(jm32, idf_requires_grad=True)
    tm = _port_model(jm32, torch.float32, idf_requires_grad=True)
    idf0 = tm.idf_vector.detach().clone()
    batches = [_batch(tm.tokenizer, seed=20 + s) for s in range(4)]
    jt, tt, losses = _run_both(jm, tm, batches, idf_requires_grad=True, idf_lr=5e-3,
                               max_grad_norm=0.5)
    for t, j in losses:
        assert t == pytest.approx(j, rel=1e-4)
    assert [g["lr"] for g in tt.optimizer.param_groups] == pytest.approx(
        [LR * (MAX_STEPS - 4) / (MAX_STEPS - WARMUP), 5e-3 * (MAX_STEPS - 4) / (MAX_STEPS - WARMUP)])
    assert not torch.equal(tm.idf_vector.detach(), idf0)  # it trained
    got_idf = tm.idf_vector.detach().numpy()
    want_idf = np.asarray(jt.state.params["idf_vector"])
    assert np.abs(got_idf - want_idf).max() <= 2 * _lr_sum(4, 5e-3) + 1e-6
    _check_params(jt, tt, 4, lr_sum=_lr_sum(4, 5e-3))


def test_gradient_accumulation_matches_jax(jm32):
    """Two microbatches of 2 queries (with their groups) per update:
    gradients averaged, one AdamW step, metrics averaged."""
    tm = _port_model(jm32, torch.float32)
    batches = [_batch(tm.tokenizer, seed=30 + s) for s in range(3)]
    jt, tt, losses = _run_both(jm32, tm, batches, gradient_accumulation_steps=2)
    for t, j in losses:
        assert t == pytest.approx(j, rel=1e-4)
    _check_params(jt, tt, 3)


def test_remat_replays_the_same_dropout_masks():
    """Dropout on (the tiny preset's 0.1): `remat` recomputes each layer in
    the backward with its generator re-seeded from (key, layer), so its
    gradients equal those without remat. The same key gives the same loss;
    another key other masks."""
    ma, da, _ = _args(tconfig)
    specs = build_loss_specs(da)
    grads, losses = {}, {}
    for remat, key in ((False, (0, 3, 0)), (True, (0, 3, 0)), (False, (0, 4, 0))):
        tm = tse.build_model(arch="tiny", idf_path="assets/idf.npz", seed=0, device="cpu",
                             remat=remat)
        assert tm.cfg.remat is remat and tm.cfg.hidden_dropout_prob == 0.1
        batch = {k: torch.from_numpy(v) for k, v in _batch(tm.tokenizer, seed=1).items()}
        loss, _ = train_loss(tm, batch, 0, specs, ma, da, dropout_key=key)
        loss.backward()
        grads[remat, key] = {k: p.grad for k, p in tm.named_parameters() if p.grad is not None}
        losses[remat, key] = loss.item()
    a, b = grads[False, (0, 3, 0)], grads[True, (0, 3, 0)]
    assert losses[False, (0, 3, 0)] == losses[True, (0, 3, 0)]
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-9)
    assert losses[False, (0, 4, 0)] != losses[False, (0, 3, 0)]

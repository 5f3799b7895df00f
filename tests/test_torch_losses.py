"""The port's ranking losses and FLOPS regulariser against the JAX package's
on the same seeded numpy inputs: values and gradients (`jax.grad` against
torch autograd), fp32. Both sides compute the same fp32 arithmetic in
another order, so 1e-5 relative. A gradient entry that is a difference of
near-equal terms carries its terms' rounding, so gradients also get an
absolute floor of 1e-6 of the tensor's largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_sparse_model_tuning_sample_tpu.core.config import DataArguments as JDataArgs
from opensearch_sparse_model_tuning_sample_tpu.ops import flops as jflops
from opensearch_sparse_model_tuning_sample_tpu.ops import losses as jlosses
from opensearch_sparse_model_tuning_sample_torch.core.config import DataArguments
from opensearch_sparse_model_tuning_sample_torch.ops import flops as tflops
from opensearch_sparse_model_tuning_sample_torch.ops import losses as tlosses

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-7)


def _reps(B, G, V, seed):
    """Non-negative sparse-ish reps, as log1p(relu) gives them."""
    rng = np.random.default_rng(seed)
    q = np.maximum(rng.normal(size=(B, V)), 0).astype(np.float32)
    d = np.maximum(rng.normal(size=(B * G, V)), 0).astype(np.float32)
    return q, d


def _both(jfn, tfn, arrays, extra_np=()):
    """Value and gradient wrt the reps in both frameworks."""
    jval, jgrads = jax.value_and_grad(
        lambda *xs: jfn(*xs, *[jnp.asarray(e) for e in extra_np]),
        argnums=tuple(range(len(arrays))))(*[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tval = tfn(*ts, *[torch.from_numpy(e) for e in extra_np])
    tval.backward()
    return (float(jval), [np.asarray(g) for g in jgrads],
            tval.item(), [t.grad.numpy() for t in ts])


def _check(jfn, tfn, arrays, extra_np=(), where=None):
    jv, jg, tv, tg = _both(jfn, tfn, arrays, extra_np)
    np.testing.assert_allclose(tv, jv, **TOL)
    for a, b in zip(tg, jg):
        if where is not None:
            a, b = a[where], b[where]
        np.testing.assert_allclose(a, b, rtol=TOL["rtol"], atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("in_batch", [False, True])
def test_infonce_matches_jax(in_batch):
    q, d = _reps(4, 3, 64, seed=1)
    _check(lambda q, d: jlosses.infonce_loss(q, d, use_in_batch_negatives=in_batch),
           lambda q, d: tlosses.infonce_loss(q, d, use_in_batch_negatives=in_batch),
           [q, d])


@pytest.mark.parametrize("kind", ["kldiv", "marginmse"])
@pytest.mark.parametrize("in_batch", [False, True])
@pytest.mark.parametrize("temperature", [1.0, 2.5])
def test_teacher_losses_match_jax(kind, in_batch, temperature):
    B, G = 4, 3
    q, d = _reps(B, G, 64, seed=2)
    rng = np.random.default_rng(3)
    teacher = rng.normal(size=(B, B * G if in_batch else G)).astype(np.float32)
    jfn = {"kldiv": jlosses.kldiv_loss, "marginmse": jlosses.margin_mse_loss}[kind]
    tfn = {"kldiv": tlosses.kldiv_loss, "marginmse": tlosses.margin_mse_loss}[kind]
    _check(lambda q, d, t: jfn(q, d, t, use_in_batch_negatives=in_batch, temperature=temperature),
           lambda q, d, t: tfn(q, d, t, use_in_batch_negatives=in_batch, temperature=temperature),
           [q, d], extra_np=(teacher,))


def test_loss_specs_from_config_match_jax():
    kw = dict(loss_types=["infonce", "kldiv"], ranking_loss_weight=0.7, temperature=2.0,
              use_in_batch_negatives=False)
    jspecs = jlosses.build_loss_specs(JDataArgs(**kw))
    tspecs = tlosses.build_loss_specs(DataArguments(**kw))
    assert [(s.kind, s.weight, s.temperature, s.use_in_batch_negatives) for s in tspecs] == \
        [(s.kind, s.weight, s.temperature, s.use_in_batch_negatives) for s in jspecs]
    q, d = _reps(3, 2, 32, seed=4)
    teacher = np.random.default_rng(5).normal(size=(3, 2)).astype(np.float32)
    for js, ts in zip(jspecs, tspecs):
        _check(lambda q, d, t: js(q, d, t), lambda q, d, t: ts(q, d, t), [q, d],
               extra_np=(teacher,))


@pytest.mark.parametrize("group_num,threshold", [(1, None), (3, None), (3, 20), (1, 35)])
def test_flops_value_matches_jax(group_num, threshold):
    rng = np.random.default_rng(group_num)
    # doc lengths spread around the threshold: some rows pay, some do not
    rep = np.maximum(rng.normal(size=(12, 64)) - rng.uniform(-1, 1.5, size=(12, 1)), 0)
    rep = rep.astype(np.float32)
    # gradients where rep != 0 only: at 0, jax.grad(abs) is 1 and torch's is
    # 0; in the train step those zeros come from relu, whose derivative at 0
    # is 0 in both, so the difference never reaches a parameter
    _check(lambda r: jflops.flops_value(r, group_num, flops_threshold=threshold),
           lambda r: tflops.flops_value(r, group_num, flops_threshold=threshold), [rep],
           where=rep != 0)


@pytest.mark.parametrize("lam,T", [(0.01, 50), (0.05, 200.0), (1e-3, None), (0.0, 10), (None, 10)])
def test_get_lambda_matches_jax(lam, T):
    for step in (0, 1, 7, 49, 50, 51, 199, 200, 1000):
        want = float(jflops.get_lambda(jnp.asarray(step, jnp.int32), lam, T))
        assert tflops.get_lambda(step, lam, T) == pytest.approx(want, rel=1e-6, abs=0)

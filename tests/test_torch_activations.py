"""The port's activation functions against the JAX package's, on the same
numpy inputs. All fp32 elementwise math or exact counts: 1e-6 covers the
two libraries' log1p implementations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_sparse_model_tuning_sample_tpu.ops import activations as ja
from opensearch_sparse_model_tuning_sample_torch.ops import activations as ta

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)


def _pooled(seed=0, B=4, V=300):
    return np.random.default_rng(seed).normal(size=(B, V)).astype(np.float32) * 3


@pytest.mark.parametrize("use_l0", [False, True])
@pytest.mark.parametrize("prune_ratio", [None, 0.1, 0.5])
def test_pooled_activation(use_l0, prune_ratio):
    x = _pooled()
    ref = np.asarray(ja.pooled_activation(jnp.asarray(x), use_l0, prune_ratio))
    got = ta.pooled_activation(torch.from_numpy(x), use_l0, prune_ratio).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("use_l0", [False, True])
@pytest.mark.parametrize("prune_ratio", [None, 0.3])
def test_sparse_activation(use_l0, prune_ratio):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 9, 50)).astype(np.float32)
    mask = (np.arange(9)[None] < np.array([9, 4, 0])[:, None]).astype(np.int32)
    ref = np.asarray(ja.sparse_activation(jnp.asarray(logits), jnp.asarray(mask),
                                          use_l0, prune_ratio))
    got = ta.sparse_activation(torch.from_numpy(logits), torch.from_numpy(mask),
                               use_l0, prune_ratio).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert (got[2] == 0).all()  # all-masked row


def test_inf_free_activation():
    rng = np.random.default_rng(2)
    V = 200
    ids = rng.integers(0, V, size=(5, 12)).astype(np.int32)
    ids[0, :3] = [101, 102, 0]  # special tokens are zeroed
    idf = rng.normal(size=(V,)).astype(np.float32)  # negative idf -> relu 0
    specials = [0, 100, 101, 102, 103]
    ref = np.asarray(ja.inf_free_activation(
        jnp.asarray(ids), jnp.asarray(idf), ja.special_token_mask(specials, V), V))
    got = ta.inf_free_activation(
        torch.from_numpy(ids), torch.from_numpy(idf), ta.special_token_mask(specials, V), V
    ).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("specials", [[], [0, 5, 7]])
def test_special_token_mask(specials):
    ref = np.asarray(ja.special_token_mask(specials, 10))
    got = ta.special_token_mask(specials, 10).numpy()
    np.testing.assert_array_equal(got, ref)


def test_activation_count():
    reps = np.maximum(_pooled(3), 0)
    ref = np.asarray(ja.activation_count(jnp.asarray(reps)))
    got = ta.activation_count(torch.from_numpy(reps)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32

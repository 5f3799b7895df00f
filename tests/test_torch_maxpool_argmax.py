"""The training forward's plain version, `maxpool_head_argmax_reference`,
which the Hopper kernel (`csrc/maxpool_head.cu`, `maxpool_head_argmax_kernel`)
is held to on the card (tests/test_torch_gpu.py, chip_smoke.py).

Its values are held against the JAX package's production head
`bert.mlm_maxpool` on the same numpy inputs and weights. Its tie rule is
pinned on inputs whose logits are small integers, exact in fp32 whatever
the order of the sums, so the expected positions come from numpy in exact
arithmetic:

  * the smallest position that attains the maximum, within a 64-position
    chunk and across chunks (an earlier chunk keeps a tie);
  * a masked position contributes exactly 0, so its 0 beats negative
    logits;
  * an all-masked row pools to 0 at position 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_sparse_model_tuning_sample_tpu.models import bert as jbert
from opensearch_sparse_model_tuning_sample_torch.ops import maxpool as mp
from test_torch_maxpool_grad import _holey_mask, _port_model

torch.set_num_threads(2)


def _expected(h, mask, w, bias):
    """Pooled values and the first position of each maximum, in float64:
    exact for integer inputs."""
    masked = (np.einsum("bld,vd->blv", h, w) + bias) * mask[:, :, None]
    return masked.max(axis=1), masked.argmax(axis=1)  # argmax: the first


def _int_case(case, B, L, D, V, seed):
    """Integer-valued h, mask, w, bias (float64 numpy) for one tie case."""
    rng = np.random.default_rng(seed)
    h = rng.integers(-1, 2, size=(B, L, D)).astype(np.float64)
    w = rng.integers(-1, 2, size=(V, D)).astype(np.float64)
    bias = rng.integers(-2, 3, size=V).astype(np.float64)
    mask = np.ones((B, L), np.int32)
    if case == "holey":
        mask = _holey_mask(B, L, rng)
    elif case == "chunk_tie":
        # rows 3 and 70 equal and far above the rest: they tie for every v
        # where they win, across two chunks
        u = 8 * rng.integers(-1, 2, size=(B, D))
        h[:, 3] = h[:, 70] = u
    elif case == "negative":
        # every logit below 0: a masked position's 0 is the maximum
        h, w = np.abs(h), np.abs(w)
        bias = -(D + 1) - np.abs(bias)
        mask[0, 5] = 0  # one hole
        mask[1, 40:] = 0  # right padding
        mask[2] = 0  # all masked
    return h, mask, w, bias


@pytest.mark.parametrize("case,B,L,D,V", [
    ("random", 4, 64, 16, 96),
    ("random", 3, 130, 8, 64),
    ("holey", 6, 192, 16, 80),
    ("chunk_tie", 3, 128, 16, 96),
    ("negative", 4, 100, 16, 64),
])
def test_argmax_reference_takes_the_first_of_tied_maxima(case, B, L, D, V):
    h, mask, w, bias = _int_case(case, B, L, D, V, seed=L + D)
    want, want_idx = _expected(h, mask, w, bias)
    pooled, idx = mp.maxpool_head_argmax_reference(
        torch.from_numpy(h).float(), torch.from_numpy(mask), torch.from_numpy(w).float(),
        torch.from_numpy(bias).float())
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(pooled.numpy(), want)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    if case == "chunk_tie":  # the tie across chunks is real, and the earlier one wins
        logits = np.einsum("bld,vd->blv", h, w) + bias
        others = np.delete(logits, [3, 70], axis=1).max(axis=1)
        both = (logits[:, 3] == want) & (logits[:, 70] == want) & (want > others)
        assert both.sum() > B * V // 4
        assert (want_idx[both] == 3).all()
    if case == "negative":
        assert (want_idx[0] == 5).all() and (want[0] == 0).all()
        assert (want_idx[1] == 40).all() and (want[1] == 0).all()
        assert (want_idx[2] == 0).all() and (want[2] == 0).all()
        assert (want[3] < 0).all()


def test_argmax_reference_ties_within_a_chunk_go_to_the_smaller_position():
    """Equal rows at positions 9 and 2 of one chunk, both the maximum for
    every v: the argmax names 2; an all-masked row pools to 0 at 0."""
    B, L, D, V = 2, 64, 8, 32
    h = np.zeros((B, L, D))
    h[:, 2] = h[:, 9] = 1.0
    w = np.ones((V, D))
    bias = np.zeros(V)
    mask = np.ones((B, L), np.int32)
    mask[1] = 0
    pooled, idx = mp.maxpool_head_argmax_reference(
        torch.from_numpy(h), torch.from_numpy(mask), torch.from_numpy(w), torch.from_numpy(bias))
    assert (idx[0] == 2).all() and (pooled[0] == D).all()
    assert (idx[1] == 0).all() and (pooled[1] == 0).all()


@pytest.mark.parametrize("L", [64, 130])
def test_argmax_reference_values_match_jax_scan_head(L):
    """The head transform of the port (JAX weights through params_from_jax)
    and the plain training forward against JAX bert.mlm_maxpool on the same
    numpy hidden states and holey mask; the logit at each argmax is the
    pooled value."""
    jcfg = jbert.config_from_preset("tiny", vocab_size=1000, compute_dtype=jnp.float32)
    params = jbert.init(jax.random.PRNGKey(11), jcfg)
    rng = np.random.default_rng(L)
    B, D = 6, jcfg.hidden_size
    hidden = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = _holey_mask(B, L, rng)
    ref = np.asarray(jbert.mlm_maxpool(params, jcfg, jnp.asarray(hidden), jnp.asarray(mask),
                                       chunk=16))
    model = _port_model(jcfg, params)
    with torch.no_grad():
        h = model.head_hidden(torch.from_numpy(hidden)).contiguous()
        w = model.decoder_weight().contiguous()
        bias = model.mlm_head.bias.float()
        pooled, idx = mp.maxpool_head_argmax_reference(h, torch.from_numpy(mask), w, bias)
        at = ((h[torch.arange(B)[:, None], idx.long()] * w).sum(-1) + bias) \
            * torch.from_numpy(mask).gather(1, idx.long())
    np.testing.assert_allclose(pooled.numpy(), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(at.numpy(), pooled.numpy(), rtol=1e-5, atol=1e-5)
    assert (pooled[4] == 0).all() and (idx[4] == 0).all()  # the all-masked row
    assert bool(((idx >= 0) & (idx < L)).all())

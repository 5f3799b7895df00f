"""The fused max-pool head's plain version (what the port runs on the CPU)
against the JAX package: the production scan head `bert.mlm_maxpool` and the
Pallas kernel `maxpool_head` in interpret mode. Inputs are made with numpy
from a seed and handed to both packages. fp32 throughout: the point here is
the function, so the tolerance is fp32 summation-order noise (1e-4, the
bound tests/test_pallas.py uses for the same comparison). The kernel itself
is held against this plain version on the card in tests/test_torch_gpu.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_sparse_model_tuning_sample_tpu.models import bert as jbert
from opensearch_sparse_model_tuning_sample_tpu.ops.pallas_maxpool import maxpool_head as pallas_maxpool_head
from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert
from opensearch_sparse_model_tuning_sample_torch.models.convert import params_from_jax
from opensearch_sparse_model_tuning_sample_torch.ops.maxpool import (
    maxpool_head,
    maxpool_head_reference,
)

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(B, L, D, V, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, L, D)).astype(np.float32)
    w = (rng.normal(size=(V, D)) * 0.05).astype(np.float32)
    bias = rng.normal(size=(V,)).astype(np.float32)
    lens = rng.integers(1, L + 1, size=B)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    mask[-1] = 0  # one all-masked row
    return h, mask, w, bias


def _plain(h, mask, w, bias):
    return maxpool_head_reference(
        torch.from_numpy(h), torch.from_numpy(mask), torch.from_numpy(w),
        torch.from_numpy(bias),
    ).numpy()


# padded rows and one all-masked row in every case; L=70 and L=45 are not
# multiples of the plain version's 64-row chunk; V=30592 is the padded vocab
@pytest.mark.parametrize("B,L,D,V", [
    (4, 32, 128, 1024),
    (3, 70, 64, 640),
    (5, 45, 32, 512),
    (2, 16, 64, 30592),
])
def test_plain_version_matches_pallas_interpret(B, L, D, V):
    h, mask, w, bias = _inputs(B, L, D, V, seed=B + L + D)
    got = _plain(h, mask, w, bias)
    ref = np.asarray(pallas_maxpool_head(
        jnp.asarray(h), jnp.asarray(mask), jnp.asarray(w.T), jnp.asarray(bias),
        tile_b=1, tile_v=512 if V % 512 == 0 else 128, chunk=1, interpret=True,
    ))
    np.testing.assert_allclose(got, ref, **TOL)
    assert (got[-1] == 0).all()  # all-masked row pools to exactly 0
    padded = ~mask.astype(bool).all(axis=1)
    assert (got[padded] >= 0).all()  # a row with any padding pools to >= 0


@pytest.mark.parametrize("untied", [False, True])
@pytest.mark.parametrize("L", [24, 70])
def test_plain_version_matches_jax_scan_head(untied, L):
    """The port's BertForMaskedLM.mlm_maxpool (head transform + the plain
    max-pool on the CPU) against JAX bert.mlm_maxpool, same fp32 weights."""
    jcfg = jbert.config_from_preset("tiny", vocab_size=1000,
                                    compute_dtype=jnp.float32)
    params = jbert.init(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(L)
    if untied:
        params["mlm_head"]["decoder"] = jnp.asarray(
            rng.normal(size=(jcfg.padded_vocab_size, jcfg.hidden_size)).astype(np.float32) * 0.02)
    B, D = 3, jcfg.hidden_size
    hidden = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = (np.arange(L)[None, :] < np.array([L, L // 2, 1])[:, None]).astype(np.int32)
    ref = np.asarray(jbert.mlm_maxpool(params, jcfg, jnp.asarray(hidden), jnp.asarray(mask), chunk=16))

    tcfg = tbert.BertConfig(**{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tbert.BertConfig)
        if f.name not in ("param_dtype", "compute_dtype")
    }, compute_dtype=torch.float32)
    model = tbert.from_state_dict(
        tcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg),
        torch.device("cpu"))
    with torch.no_grad():
        got = model.mlm_maxpool(torch.from_numpy(hidden), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_wrapper_takes_the_plain_version_on_cpu_only():
    h, mask, w, bias = _inputs(3, 20, 16, 100, seed=7)
    before = maxpool_head.launches
    got = maxpool_head(torch.from_numpy(h), torch.from_numpy(mask),
                       torch.from_numpy(w), torch.from_numpy(bias))
    assert maxpool_head.launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(got.numpy(), _plain(h, mask, w, bias))
    with pytest.raises(ValueError):
        maxpool_head(torch.empty(2, 3, 8, device="meta"), torch.empty(2, 3, device="meta"),
                     torch.empty(5, 8, device="meta"), torch.empty(5, device="meta"))


def test_plain_version_chunking_is_exact():
    """The chunk size only changes which rows meet in one matmul."""
    h, mask, w, bias = _inputs(4, 50, 16, 64, seed=11)
    t = [torch.from_numpy(x) for x in (h, mask, w, bias)]
    a = maxpool_head_reference(*t, chunk=7).numpy()
    b = maxpool_head_reference(*t, chunk=64).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)

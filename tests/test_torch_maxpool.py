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
    check_kernel_args,
    launch_counts,
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


def _holey_mask(B, L, rng):
    """Masks the kernel's 64-position chunk skip must get right: left
    padding, interior holes, a fully masked 64-wide chunk in the middle of a
    row (where L allows), right padding, an all-masked row and a full row."""
    mask = np.ones((B, L), np.int32)
    mask[0, : L // 3] = 0  # left padding
    mask[1, rng.choice(L, size=max(1, L // 4), replace=False)] = 0  # interior holes
    if L >= 192:
        mask[2, 64:128] = 0  # one whole chunk masked, live chunks around it
    else:
        mask[2, L // 3: 2 * L // 3] = 0
    mask[3, L // 2:] = 0  # right padding
    mask[4] = 0  # all masked
    return mask


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


@pytest.mark.parametrize("L", [40, 192])
def test_plain_version_matches_pallas_interpret_on_holey_masks(L):
    """Left padding, interior holes and a fully masked chunk in mid-row: a
    masked position contributes exactly 0 wherever it sits."""
    B, D, V = 6, 32, 256
    rng = np.random.default_rng(L)
    h, _, w, bias = _inputs(B, L, D, V, seed=L)
    mask = _holey_mask(B, L, rng)
    got = _plain(h, mask, w, bias)
    ref = np.asarray(pallas_maxpool_head(
        jnp.asarray(h), jnp.asarray(mask), jnp.asarray(w.T), jnp.asarray(bias),
        tile_b=B, tile_v=128, chunk=8, interpret=True,
    ))
    np.testing.assert_allclose(got, ref, **TOL)
    assert (got[4] == 0).all()  # all-masked row pools to exactly 0
    assert (got[:4] >= 0).all()  # a row with any masked position pools to >= 0
    assert (got[5] < 0).any()  # the full row may pool below 0


@pytest.mark.parametrize("L", [40, 192])
def test_plain_version_matches_jax_scan_head_on_holey_masks(L):
    """The port's BertForMaskedLM.mlm_maxpool against JAX bert.mlm_maxpool
    on the same holey masks, same fp32 weights."""
    jcfg = jbert.config_from_preset("tiny", vocab_size=1000, compute_dtype=jnp.float32)
    params = jbert.init(jax.random.PRNGKey(5), jcfg)
    rng = np.random.default_rng(L + 1)
    B, D = 6, jcfg.hidden_size
    hidden = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = _holey_mask(B, L, rng)
    ref = np.asarray(jbert.mlm_maxpool(params, jcfg, jnp.asarray(hidden), jnp.asarray(mask), chunk=8))
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
    assert (got[4] == 0).all()


def _kernel_args(B=2, L=8, D=32, V=64):
    return (torch.zeros(B, L, D, dtype=torch.bfloat16), torch.ones(B, L, dtype=torch.int32),
            torch.zeros(V, D, dtype=torch.bfloat16), torch.zeros(V, dtype=torch.float32))


def test_kernel_argument_checks_accept_what_the_kernel_takes():
    check_kernel_args(*_kernel_args(), max_dim=1536)
    check_kernel_args(*_kernel_args(D=1536), max_dim=1536)


@pytest.mark.parametrize("case", [
    "D_not_multiple_of_8", "D_above_max", "h_misaligned", "w_misaligned", "shapes_disagree",
    "h_not_contiguous", "empty_batch",
])
def test_kernel_argument_checks_raise_value_error(case):
    """The checks run before any launch, on any device: a sliced view that
    breaks TMA's 16-byte alignment raises instead of reaching the card."""
    h, mask, w, bias = _kernel_args()
    max_dim = 1536
    if case == "D_not_multiple_of_8":
        h, mask, w, bias = _kernel_args(D=20)
    elif case == "D_above_max":
        h, mask, w, bias = _kernel_args(D=1544)
    elif case == "h_misaligned":
        buf = torch.zeros(h.numel() + 1, dtype=torch.bfloat16)
        h = buf[1:].view(h.shape)  # contiguous, 2 bytes off a 16-byte boundary
        assert h.is_contiguous() and h.data_ptr() % 16
    elif case == "w_misaligned":
        buf = torch.zeros(w.numel() + 4, dtype=torch.bfloat16)
        w = buf[4:].view(w.shape)
        assert w.data_ptr() % 16
    elif case == "shapes_disagree":
        bias = torch.zeros(63)
    elif case == "h_not_contiguous":
        h = torch.zeros(2, 32, 8, dtype=torch.bfloat16).transpose(1, 2)
    elif case == "empty_batch":
        h, mask = h[:0], mask[:0]
    with pytest.raises(ValueError):
        check_kernel_args(h, mask, w, bias, max_dim=max_dim)


@pytest.mark.parametrize("case", ["h_float", "w_float", "mask_int64", "bias_bf16"])
def test_kernel_argument_checks_raise_type_error(case):
    h, mask, w, bias = _kernel_args()
    h = h.float() if case == "h_float" else h
    w = w.float() if case == "w_float" else w
    mask = mask.long() if case == "mask_int64" else mask
    bias = bias.bfloat16() if case == "bias_bf16" else bias
    with pytest.raises(TypeError):
        check_kernel_args(h, mask, w, bias, max_dim=1536)


def test_wrapper_takes_the_plain_version_on_cpu_only():
    h, mask, w, bias = _inputs(3, 20, 16, 100, seed=7)
    before = launch_counts()["kernels"]["maxpool_head"]
    got = maxpool_head(torch.from_numpy(h), torch.from_numpy(mask),
                       torch.from_numpy(w), torch.from_numpy(bias))
    assert launch_counts()["kernels"]["maxpool_head"] == before  # no kernel on the CPU
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

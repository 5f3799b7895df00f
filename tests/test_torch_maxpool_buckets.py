"""bwd_h's counting sort: `bucket_by_argmax_reference`, the plain version of
the bucketing launch of `csrc/maxpool_head_bwd.cu` (on the card the kernel
is held to it bit for bit, tests/test_torch_gpu.py).

It lists the nonzero coefficients coef[b, v] = g[b, v] * mask[b, idx[b, v]]
per (doc, argmax position) in increasing v. Held here, on seeded numpy
inputs, to:

  * its contract: lists in increasing v, offsets that add up to nnz, every
    nonzero coefficient once;
  * a plain reduce over its lists (dh[b, l] = sum coef * w[v]), which equals
    `maxpool_head_bwd_h_reference` (float64, 1e-10) and, through the port's
    MLM-head transform, `jax.grad` of the JAX package's `bert.mlm_maxpool`
    with tests/test_torch_maxpool_grad.py's harness and tolerance (1e-4
    relative, an absolute floor of 1e-5 of the largest entry);
  * the card tests' cases: one position winning every v of a doc, g all
    zero, g with no zero, an all-masked doc, L > 512.

Also the backward wrappers' argument checks, which run on any device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_sparse_model_tuning_sample_tpu.models import bert as jbert
from opensearch_sparse_model_tuning_sample_torch.ops import maxpool as mp
from test_torch_gpu import _calls, _launches
from test_torch_maxpool_grad import _close, _holey_mask, _port_model

torch.set_num_threads(2)


def _case(case, B, L, V, seed, dtype=np.float32):
    """(g, idx, mask) as numpy: about half of g zero, argmax positions
    anywhere in [0, L), rows padded to a length in [L/2, L]."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(L // 2, L + 1, size=B)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    idx = rng.integers(0, L, size=(B, V)).astype(np.int32)
    g = (rng.normal(size=(B, V)) * (rng.random((B, V)) < 0.5)).astype(dtype)
    if case == "skew":  # one position wins every v of each doc
        idx[:] = (np.arange(B) % (L // 2))[:, None]
    elif case == "g_zero":
        g[:] = 0
    elif case == "g_dense":  # no zero at all: nnz = B * V
        g = rng.normal(size=(B, V)).astype(dtype)
        g[g == 0] = 1
        mask[:] = 1
    elif case == "masked_doc":
        mask[1] = 0
    return g, idx, mask


def _lists(g, idx, mask):
    return mp.bucket_by_argmax_reference(torch.from_numpy(g), torch.from_numpy(idx),
                                         torch.from_numpy(mask))


def _reduce(offsets, v, coef, w, B, L):
    """dh [B, L, D] = sum over each list of coef * w[v], in list order."""
    counts = (offsets[1:] - offsets[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(B * L), counts)
    dh = torch.zeros(B * L, w.shape[1], dtype=w.dtype)
    dh.index_add_(0, rows, coef.to(w.dtype)[:, None] * w[v.long()])
    return dh.view(B, L, -1)


# (case, B, L, V): the same kinds of input as the card tests, at CPU sizes;
# L = 600 spans more than 512 positions
CASES = [
    ("random", 5, 24, 130),
    ("skew", 5, 24, 130),
    ("g_zero", 3, 16, 64),
    ("g_dense", 4, 16, 96),
    ("masked_doc", 4, 40, 200),
    ("random", 3, 600, 300),
]


@pytest.mark.parametrize("case,B,L,V", CASES)
def test_lists_hold_each_nonzero_coefficient_once_in_increasing_v(case, B, L, V):
    g, idx, mask = _case(case, B, L, V, seed=B * L + V)
    offsets, v, coef = _lists(g, idx, mask)
    assert offsets.dtype == v.dtype == torch.int32 and coef.dtype == torch.float32
    full = g * np.take_along_axis(mask, idx, axis=1).astype(np.float32)
    for b in range(B):
        for l in range(L):
            a, e = int(offsets[b * L + l]), int(offsets[b * L + l + 1])
            want = np.nonzero((idx[b] == l) & (full[b] != 0))[0]
            got = v[a:e].numpy()
            assert np.all(np.diff(got) > 0), (b, l)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(coef[a:e].numpy(), full[b, want])
            if mask[b, l] == 0:
                assert a == e  # a masked position's list is empty


@pytest.mark.parametrize("case,B,L,V", CASES)
def test_offsets_add_up_to_nnz(case, B, L, V):
    g, idx, mask = _case(case, B, L, V, seed=B + L + V)
    offsets, v, coef = _lists(g, idx, mask)
    nnz = int(np.count_nonzero(g * np.take_along_axis(mask, idx, axis=1)))
    assert offsets.shape == (B * L + 1,) and int(offsets[0]) == 0
    assert bool((offsets[1:] >= offsets[:-1]).all())
    assert int(offsets[-1]) == nnz == v.numel() == coef.numel()
    if case == "g_zero":
        assert nnz == 0
    if case == "g_dense":
        assert nnz == B * V
    if case == "skew":  # each doc's nonzero gradients all in one list
        per_list = (offsets[1:] - offsets[:-1]).view(B, L)
        assert bool(((per_list > 0).sum(dim=1) <= 1).all())


@pytest.mark.parametrize("case,B,L,V", CASES)
def test_reduce_over_lists_is_the_plain_bwd_h(case, B, L, V):
    """float64: the reduce over the lists is the dense scatter + matmul."""
    g, idx, mask = _case(case, B, L, V, seed=7 * B + L, dtype=np.float64)
    w = torch.from_numpy(np.random.default_rng(L).normal(size=(V, 8)))
    offsets, v, coef = _lists(g, idx, mask)
    want = mp.maxpool_head_bwd_h_reference(torch.from_numpy(g), torch.from_numpy(idx),
                                           torch.from_numpy(mask), w)
    torch.testing.assert_close(_reduce(offsets, v, coef, w, B, L), want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("untied", [False, True])
@pytest.mark.parametrize("L", [24, 70])
def test_reduce_over_lists_matches_jax_grad(untied, L):
    """The reduce's dh, taken back through the port's MLM-head transform,
    equals jax.grad of the JAX head with respect to the hidden states."""
    jcfg = jbert.config_from_preset("tiny", vocab_size=1000, compute_dtype=jnp.float32)
    params = jbert.init(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(100 + L + untied)
    if untied:
        params["mlm_head"]["decoder"] = jnp.asarray(
            rng.normal(size=(jcfg.padded_vocab_size, jcfg.hidden_size)).astype(np.float32) * 0.02)
    B, D, V = 6, jcfg.hidden_size, jcfg.padded_vocab_size
    hidden = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = _holey_mask(B, L, rng)
    G = rng.normal(size=(B, V)).astype(np.float32)
    G[:, jcfg.vocab_size:] = 0.0  # the encoder drops the padded vocab columns
    G[rng.random((B, V)) < 0.5] = 0.0  # relu leaves much of it 0

    def jloss(x):
        return jnp.sum(jbert.mlm_maxpool(params, jcfg, x, jnp.asarray(mask), chunk=16) * G)

    jg_x = jax.grad(jloss)(jnp.asarray(hidden))

    model = _port_model(jcfg, params)
    x = torch.from_numpy(hidden).requires_grad_()
    h = model.head_hidden(x)
    tmask = torch.from_numpy(mask)
    with torch.no_grad():
        w = model.decoder_weight()
        _, idx = mp.maxpool_head_argmax_reference(h, tmask, w, model.mlm_head.bias)
        offsets, v, coef = mp.bucket_by_argmax_reference(torch.from_numpy(G), idx, tmask)
        dh = _reduce(offsets, v, coef, w, B, L)
    dx, = torch.autograd.grad(h, x, dh)
    _close(dx.numpy(), np.asarray(jg_x), "d hidden through the bucket reduce")
    assert (dx[4] == 0).all()  # the all-masked row sends nothing back


def test_bucket_wrapper_takes_the_plain_version_on_the_cpu():
    g, idx, mask = (torch.from_numpy(a) for a in _case("random", 3, 10, 40, seed=1))
    calls = _calls(mp.bucket_by_argmax_reference)
    launches = _launches(mp.maxpool_head_bwd_buckets)
    got = mp.maxpool_head_bwd_buckets(g, idx, mask)
    want = mp.bucket_by_argmax_reference(g, idx, mask)
    assert _launches(mp.maxpool_head_bwd_buckets) == launches
    assert _calls(mp.bucket_by_argmax_reference) == calls + 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="no autograd"):
        mp.maxpool_head_bwd_buckets(g.requires_grad_(), idx, mask)


def _args(B=2, L=8, D=32, V=64):
    return (torch.zeros(B, V), torch.zeros(B, V, dtype=torch.int32),
            torch.ones(B, L, dtype=torch.int32), torch.zeros(B, L, D, dtype=torch.bfloat16),
            torch.zeros(V, D, dtype=torch.bfloat16))


@pytest.mark.parametrize("case,exc", [
    ("ok", None), ("g_float64", TypeError), ("mask_int64", TypeError),
    ("mask_batch", ValueError), ("mask_not_contiguous", ValueError), ("empty_sequence", ValueError),
    ("h_ok", None), ("h_length", ValueError), ("h_batch", ValueError), ("w_rows", ValueError),
    ("w_1d", ValueError),
])
def test_bucket_and_shape_checks(case, exc):
    """The counting sort's checks (check_bucket_args), and the gradient
    kernels' checks of h and w against the batch (check_bwd_args): both run
    before any launch, on any device."""
    g, idx, mask, h, w = _args()
    x = w
    if case == "g_float64":
        g = g.double()
    elif case == "mask_int64":
        mask = mask.long()
    elif case == "mask_batch":
        mask = torch.ones(3, 8, dtype=torch.int32)
    elif case == "mask_not_contiguous":
        mask = torch.ones(8, 2, dtype=torch.int32).t()
    elif case == "empty_sequence":
        mask = torch.ones(2, 0, dtype=torch.int32)
    elif case == "h_ok":
        x = h
    elif case == "h_length":
        x = h[:, :5].contiguous()
    elif case == "h_batch":
        x = torch.zeros(3, 8, 32, dtype=torch.bfloat16)
    elif case == "w_rows":
        x = w[:40]
    elif case == "w_1d":
        x = torch.zeros(64 * 32, dtype=torch.bfloat16)

    def run():
        mp.check_bucket_args(g, idx, mask)
        if case.startswith(("h_", "w_")):
            mp.check_bwd_args(g, idx, mask, x, max_dim=1536)

    if exc is None:
        run()
    else:
        with pytest.raises(exc):
            run()

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips where no CUDA device exists (the
check runs inside the fixture, never at import). The file imports torch and
numpy only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from opensearch_sparse_model_tuning_sample_torch.ops.maxpool import (
    _lib,
    launch_counts,
    maxpool_head,
    maxpool_head_reference,
)

pytestmark = pytest.mark.gpu


def _launches(f):
    """The counted kernel launches of the wrapper f so far."""
    return launch_counts()["kernels"][f.__name__]


def _calls(f):
    """The counted calls of the plain version f so far."""
    return launch_counts()["plains"][f.__name__]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, L, D, V, seed, device, mask=None):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(V, D)) * 0.05).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(V,)).astype(np.float32))
    if mask is None:
        lens = rng.integers(1, L + 1, size=B)
        mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
        mask[-1] = 0  # one all-masked row
    return (h.to(device, torch.bfloat16), torch.from_numpy(mask).to(device),
            w.to(device, torch.bfloat16), bias.to(device))


def _holey_mask(B, L, seed):
    """Left padding, interior holes, a fully masked 64-position chunk (the
    kernel's skip unit) in the middle of a live row, right padding, an
    all-masked row; any further rows are full."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, L), np.int32)
    mask[0, : L // 3] = 0
    mask[1, rng.choice(L, size=L // 4, replace=False)] = 0
    mask[2, 64:128] = 0
    mask[3, L // 2:] = 0
    mask[4] = 0
    return mask


def _check(h, mask, w, bias):
    before = _launches(maxpool_head)
    got = maxpool_head(h, mask, w, bias)
    torch.cuda.synchronize()
    assert _launches(maxpool_head) == before + 1
    ref = maxpool_head_reference(h, mask, w, bias)
    # both sides sum exact bf16 products in fp32, in another order
    err = (got - ref).abs()
    assert bool((err <= 1e-3 * ref.abs().clamp_min(1.0)).all()), float(err.max())
    dead = ~mask.bool().any(dim=1)
    assert bool((got[dead] == 0).all())  # an all-masked row pools to exactly 0
    padded = ~mask.bool().all(dim=1)  # a row with any masked position pools to >= 0
    assert bool((got[padded] >= 0).all())
    return got


# (B, L, D, V): the mini ingest shapes; the base width; L = 45 and 600, not
# multiples of the kernel's 64-position chunk (600 spans ten); D = 264, not a
# multiple of the 64-column K box; D = 8, the narrowest; D = 1024 (large,
# the 64-row vocab tile); V = 300, under one vocab tile, and V = 777, a
# ragged vocab edge
@pytest.mark.parametrize("B,L,D,V", [
    (50, 128, 256, 30592),
    (50, 512, 256, 30592),
    (8, 512, 768, 30592),
    (5, 45, 256, 1000),
    (4, 600, 256, 777),
    (9, 64, 264, 777),
    (6, 70, 8, 500),
    (3, 40, 1024, 300),
])
def test_maxpool_kernel_matches_plain_version(cuda, B, L, D, V):
    _check(*_inputs(B, L, D, V, seed=B * L + D, device=cuda))


@pytest.mark.parametrize("B,L,D,V", [(6, 600, 256, 30592), (6, 200, 768, 777),
                                     (5, 192, 1024, 300)])
def test_maxpool_kernel_on_holey_masks(cuda, B, L, D, V):
    mask = _holey_mask(B, L, seed=L)
    _check(*_inputs(B, L, D, V, seed=L + D, device=cuda, mask=mask))


def test_maxpool_kernel_at_d_1032(cuda):
    """Above `large`: matches where the kernel takes it, raises where not."""
    h, mask, w, bias = _inputs(3, 70, 1032, 300, seed=1, device=cuda)
    if 1032 > _lib().maxpool_head_max_dim():
        with pytest.raises(ValueError):
            maxpool_head(h, mask, w, bias)
    else:
        _check(h, mask, w, bias)


def test_maxpool_kernel_is_deterministic(cuda):
    """No atomics and no carry between blocks: two launches are bit-equal."""
    h, mask, w, bias = _inputs(50, 128, 256, 30592, seed=3, device=cuda)
    a = maxpool_head(h, mask, w, bias)
    b = maxpool_head(h, mask, w, bias)
    assert torch.equal(a, b)


def test_maxpool_kernel_rejects_what_it_cannot_take(cuda):
    h, mask, w, bias = _inputs(2, 8, 20, 64, seed=0, device=cuda)
    with pytest.raises(ValueError):
        maxpool_head(h, mask, w, bias)  # D % 8 != 0
    h, mask, w, bias = _inputs(2, 8, 32, 64, seed=0, device=cuda)
    with pytest.raises(TypeError):
        maxpool_head(h.float(), mask, w, bias)
    with pytest.raises(TypeError):
        maxpool_head(h, mask.long(), w, bias)
    # a contiguous view 2 bytes off a 16-byte boundary: TMA cannot read it
    buf = torch.empty(h.numel() + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        maxpool_head(buf[1:].view(h.shape), mask, w, bias)
    # past the widest resident vocab tile the ingest kernel streams its w
    # tile, up to its own limit; the training forward keeps the resident one
    too_wide = _lib().maxpool_head_ingest_max_dim() + 8
    h, mask, w, bias = _inputs(2, 8, too_wide, 64, seed=0, device=cuda)
    with pytest.raises(ValueError):
        maxpool_head(h, mask, w, bias)
    past_resident = _lib().maxpool_head_max_dim() + 8
    h, mask, w, bias = _inputs(2, 70, past_resident, 300, seed=0, device=cuda)
    with pytest.raises(ValueError):
        mp.maxpool_head_argmax(h, mask, w, bias)
    _check(h, mask, w, bias)


# ---- the training kernels: argmax forward, bwd_w, bwd_h -------------------

from opensearch_sparse_model_tuning_sample_torch.ops import maxpool as mp  # noqa: E402


def _value_at(h, mask, w, bias, idx):
    """mask * (h[b, idx] . w[v] + bias[v]) per (b, v), in fp32."""
    out = torch.empty(idx.shape, device=h.device)
    wf = w.float()
    for b in range(h.shape[0]):
        li = idx[b].long()
        out[b] = ((h[b].float()[li] * wf).sum(1) + bias) * mask[b].float()[li]
    return out


def _rel_ok(got, ref, tol=1e-3):
    return bool(((got - ref).abs() <= tol * ref.abs().clamp_min(1.0)).all())


def _bf16_ok(got, ref, tol=1e-3):
    """A bf16 kernel output against the fp32 plain version: the kernel sums
    in fp32 in another order than the plain matmul (tol, as `_rel_ok`), then
    rounds once to the nearest bf16, which moves a value by at most half a
    bf16 ulp: 2^-8 of the rounded value."""
    assert got.dtype == torch.bfloat16
    got = got.float()
    return bool(((got - ref).abs() <= tol * ref.abs().clamp_min(1.0)
                 + 2.0 ** -8 * got.abs()).all())


@pytest.mark.parametrize("B,L,D,V,holey", [
    (45, 64, 256, 30592, False),
    (6, 600, 256, 30592, True),
    (5, 45, 768, 777, False),
    (6, 200, 1024, 300, True),
])
def test_training_kernels_match_plain_versions(cuda, B, L, D, V, holey):
    """The argmax forward's values equal the plain head's and the logit at
    its argmax is the pooled value (near-ties may pick another position than
    the plain argmax, so values are compared, not indices); given that
    argmax, bwd_w and bwd_h equal the dense-scatter backward. Each kernel
    counts one launch; two launches of each are bit-equal."""
    mask = _holey_mask(B, L, seed=L) if holey else None
    h, mask, w, bias = _inputs(B, L, D, V, seed=B + L + D, device=cuda, mask=mask)
    counts = (_launches(mp.maxpool_head_argmax), _launches(mp.maxpool_head_bwd_w),
              _launches(mp.maxpool_head_bwd_h))
    pooled, idx = mp.maxpool_head_argmax(h, mask, w, bias)
    g = torch.randn(B, V, device=cuda) * (torch.rand(B, V, device=cuda) < 0.5)
    dw, dbias = mp.maxpool_head_bwd_w(g, idx, mask, h)
    dh = mp.maxpool_head_bwd_h(g, idx, mask, w)
    torch.cuda.synchronize()
    assert (_launches(mp.maxpool_head_argmax), _launches(mp.maxpool_head_bwd_w),
            _launches(mp.maxpool_head_bwd_h)) == tuple(c + 1 for c in counts)
    assert _rel_ok(pooled, mp.maxpool_head_reference(h, mask, w, bias))
    assert bool(((idx >= 0) & (idx < L)).all())
    assert _rel_ok(_value_at(h, mask, w, bias, idx), pooled)
    dead = ~mask.bool().any(dim=1)
    assert bool((pooled[dead] == 0).all())
    rdw, rdbias = mp.maxpool_head_bwd_w_reference(g, idx, mask, h)
    assert _bf16_ok(dw, rdw) and _rel_ok(dbias, rdbias)
    assert _bf16_ok(dh, mp.maxpool_head_bwd_h_reference(g, idx, mask, w))
    assert bool((dh[dead] == 0).all()) and bool((dh[mask == 0] == 0).all())
    assert torch.equal(mp.maxpool_head_argmax(h, mask, w, bias)[1], idx)
    assert torch.equal(mp.maxpool_head_bwd_w(g, idx, mask, h)[0], dw)
    assert torch.equal(mp.maxpool_head_bwd_h(g, idx, mask, w), dh)


def _tie_case(case, B, L, D, V, seed, device):
    """h, w in {-1, 0, 1} and an integer bias: every logit is a small
    integer, exact in fp32 whatever the order of the sums, so ties are
    everywhere and the plain argmax on the card is the exact answer.
    chunk_tie: equal rows at positions 3 and 70 (two chunks) above the rest;
    quad_tie: equal rows at positions 2, 5 and 33, held by three lanes of a
    quad; negative: every logit < 0, so a masked position's 0 wins (one hole
    in row 0 at 5, row 1 padded from 40, row 2 all masked)."""
    rng = np.random.default_rng(seed)
    h = rng.integers(-1, 2, size=(B, L, D))
    w = rng.integers(-1, 2, size=(V, D))
    bias = rng.integers(-2, 3, size=V)
    mask = np.ones((B, L), np.int32)
    if case == "holey":
        mask = _holey_mask(B, L, seed)
    elif case == "chunk_tie":
        h[:, 3] = h[:, 70] = 32 * rng.integers(-1, 2, size=(B, D))
    elif case == "quad_tie":
        h[:, 2] = h[:, 5] = h[:, 33] = 32 * rng.integers(-1, 2, size=(B, D))
    elif case == "negative":
        h, w = np.abs(h), np.abs(w)
        bias = -(D + 1) - np.abs(bias)
        mask[0, 5] = 0
        mask[1, 40:] = 0
        mask[2] = 0
    return (torch.from_numpy(h).to(device, torch.bfloat16), torch.from_numpy(mask).to(device),
            torch.from_numpy(w).to(device, torch.bfloat16),
            torch.from_numpy(bias).to(device, torch.float32))


# (case, B, L, D, V): the train step's shape; L = 100, not a multiple of 64,
# with the unpadded vocab (a partial last tile); L = 512, eight chunks
# carrying the running max and index, one of them fully masked; ties across
# chunks and across a quad's lanes; masked zeros over negative logits; the
# base width D = 768 (128-row tile) and D = 1024 (64 rows)
@pytest.mark.parametrize("case,B,L,D,V", [
    ("random", 45, 64, 256, 30592),
    ("random", 6, 100, 256, 30522),
    ("holey", 6, 512, 256, 30592),
    ("chunk_tie", 5, 128, 256, 30592),
    ("quad_tie", 5, 64, 256, 4096),
    ("negative", 4, 100, 256, 777),
    ("random", 4, 512, 768, 30592),
    ("holey", 5, 200, 1024, 300),
])
def test_training_forward_takes_the_first_of_tied_maxima(cuda, case, B, L, D, V):
    """On exact integer logits the kernel's idx equals the plain argmax (the
    smallest position of each maximum) and its out equals the plain version
    and the ingest kernel bit for bit; two launches are bit-equal."""
    h, mask, w, bias = _tie_case(case, B, L, D, V, seed=B + L + D, device=cuda)
    pooled, idx = mp.maxpool_head_argmax(h, mask, w, bias)
    want, want_idx = mp.maxpool_head_argmax_reference(h, mask, w, bias)
    torch.cuda.synchronize()
    assert torch.equal(idx, want_idx)
    assert torch.equal(pooled, want)
    assert torch.equal(pooled, maxpool_head(h, mask, w, bias))
    again, again_idx = mp.maxpool_head_argmax(h, mask, w, bias)
    assert torch.equal(again, pooled) and torch.equal(again_idx, idx)
    if case == "chunk_tie":
        assert int((idx == 3).sum()) > B * V // 4 and not bool((idx == 70).any())
    if case == "quad_tie":
        assert int((idx == 2).sum()) > B * V // 4
        assert not bool(((idx == 5) | (idx == 33)).any())
    if case == "negative":
        assert bool((idx[0] == 5).all() and (idx[1] == 40).all() and (idx[2] == 0).all())
        assert not bool(pooled[:3].any()) and bool((pooled[3] < 0).all())


@pytest.mark.parametrize("B,L,D,V", [
    (45, 64, 256, 30592), (45, 128, 256, 30592), (45, 512, 256, 30592), (8, 512, 768, 30592),
    (7, 100, 256, 30522),
])
def test_training_forward_values_equal_the_ingest_kernel(cuda, B, L, D, V):
    """Random inputs with holey masks: the training forward's out is the
    ingest kernel's bit for bit (the same products in the same order), and
    the logit at its argmax is that value."""
    h, mask, w, bias = _inputs(B, L, D, V, seed=7 * B + L, device=cuda,
                               mask=_holey_mask(B, L, seed=L) if L >= 128 else None)
    pooled, idx = mp.maxpool_head_argmax(h, mask, w, bias)
    assert torch.equal(pooled, maxpool_head(h, mask, w, bias))
    assert bool(((idx >= 0) & (idx < L)).all())
    assert _rel_ok(_value_at(h, mask, w, bias, idx), pooled)


def test_head_function_on_the_card_matches_plain_autograd(cuda):
    """MaxPoolHead on CUDA tensors (the kernels) against torch autograd of
    the plain head on the same bf16 inputs: the kernels' gradients are
    rounded to bf16 for h and w (their dtype), so 1e-2 relative."""
    B, L, D, V = 8, 64, 256, 4096
    h, mask, w, bias = _inputs(B, L, D, V, seed=5, device=cuda)
    G = torch.randn(B, V, device=cuda)
    hk, wk, bk = (t.clone().requires_grad_() for t in (h, w, bias))
    (mp.maxpool_head_train(hk, mask, wk, bk) * G).sum().backward()
    hp, wp, bp = (t.float().clone().requires_grad_() for t in (h, w, bias))
    (mp.maxpool_head_reference(hp, mask, wp, bp) * G).sum().backward()
    for got, ref in ((hk.grad, hp.grad), (wk.grad, wp.grad), (bk.grad, bp.grad)):
        assert _rel_ok(got.float(), ref, tol=1e-2)


# ---- the backward kernels' own cases: bwd_h's counting sort, skew, zeros ---


def _bwd_case(case, B, L, D, V, seed, device):
    """(g, idx, mask, h, w) for the backward kernels alone, with idx made
    directly (any position in [0, L)) rather than by the forward."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(device, torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(V, D)) * 0.05).astype(np.float32)).to(
        device, torch.bfloat16)
    lens = rng.integers(L // 2, L + 1, size=B)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    idx = rng.integers(0, L, size=(B, V)).astype(np.int32)
    g = rng.normal(size=(B, V)).astype(np.float32)
    g *= rng.random((B, V)) < 0.5
    if case == "skew":  # one position wins every v of each doc
        idx[:] = (np.arange(B) % (L // 2))[:, None]
    elif case == "g_zero":
        g[:] = 0.0
    elif case == "g_dense":  # no zero at all: nnz = B * V
        g = rng.normal(size=(B, V)).astype(np.float32)
        g[g == 0] = 1.0
        mask[:] = 1
    elif case == "masked_doc":
        mask[1] = 0
    return (torch.from_numpy(g).to(device), torch.from_numpy(idx).to(device),
            torch.from_numpy(mask).to(device), h, w)


# (case, B, L, D, V): the train step's shape; the worst skew; g all zero; g
# with no zero; an all-masked doc; L = 600 (above 512, positions in one
# window); D = 768 and 1024; a ragged vocab edge
_BWD_CASES = [
    ("random", 45, 64, 256, 30592),
    ("skew", 45, 64, 256, 30592),
    ("g_zero", 8, 64, 256, 4096),
    ("g_dense", 8, 64, 256, 30592),
    ("masked_doc", 6, 128, 256, 30592),
    ("random", 6, 600, 256, 30592),
    ("skew", 4, 600, 768, 30592),
    ("random", 5, 200, 768, 30592),
    ("masked_doc", 4, 70, 1024, 777),
]


@pytest.mark.parametrize("case,B,L,D,V", _BWD_CASES)
def test_bwd_buckets_equal_plain_bucketing(cuda, case, B, L, D, V):
    """bwd_h's counting sort on the card lists the same entries in the same
    order with the same bits as the plain version; one counted launch."""
    g, idx, mask, _, _ = _bwd_case(case, B, L, D, V, seed=B + L, device=cuda)
    before = _launches(mp.maxpool_head_bwd_buckets)
    off, v, coef = mp.maxpool_head_bwd_buckets(g, idx, mask)
    torch.cuda.synchronize()
    assert _launches(mp.maxpool_head_bwd_buckets) == before + 1
    roff, rv, rcoef = mp.bucket_by_argmax_reference(g, idx, mask)
    nnz = int(roff[-1])
    assert torch.equal(off, roff)
    assert torch.equal(v[:nnz], rv)
    assert torch.equal(coef[:nnz].view(torch.int32), rcoef.view(torch.int32))
    if case == "g_zero":
        assert nnz == 0
    if case == "g_dense":
        assert nnz == B * V


@pytest.mark.parametrize("case,B,L,D,V", _BWD_CASES)
def test_bwd_kernels_match_plain_versions(cuda, case, B, L, D, V):
    """bwd_w and bwd_h against their plain versions (bf16 outputs, see
    `_bf16_ok`), masked positions exactly 0, two launches bit-equal."""
    g, idx, mask, h, w = _bwd_case(case, B, L, D, V, seed=B * L + D, device=cuda)
    dw, dbias = mp.maxpool_head_bwd_w(g, idx, mask, h)
    dh = mp.maxpool_head_bwd_h(g, idx, mask, w)
    torch.cuda.synchronize()
    assert dw.dtype == dh.dtype == torch.bfloat16 and dbias.dtype == torch.float32
    rdw, rdbias = mp.maxpool_head_bwd_w_reference(g, idx, mask, h)
    assert _bf16_ok(dw, rdw) and _rel_ok(dbias, rdbias)
    assert _bf16_ok(dh, mp.maxpool_head_bwd_h_reference(g, idx, mask, w))
    assert bool((dh[mask == 0] == 0).all())
    if case == "g_zero":
        assert not dw.any() and not dbias.any() and not dh.any()
    dw2, dbias2 = mp.maxpool_head_bwd_w(g, idx, mask, h)
    assert torch.equal(dw2, dw) and torch.equal(dbias2, dbias)
    assert torch.equal(mp.maxpool_head_bwd_h(g, idx, mask, w), dh)


def test_bwd_kernels_reject_what_they_cannot_take(cuda):
    g, idx, mask, h, w = _bwd_case("random", 2, 8, 32, 64, seed=0, device=cuda)
    with pytest.raises(ValueError):
        mp.maxpool_head_bwd_h(g, idx, mask, w[:40])  # w rows != V
    with pytest.raises(ValueError):
        mp.maxpool_head_bwd_w(g, idx, mask, h[:, :5].contiguous())  # h's L != mask's
    with pytest.raises(TypeError):
        mp.maxpool_head_bwd_buckets(g.double(), idx, mask)
    with pytest.raises(ValueError):
        mp.maxpool_head_bwd_buckets(g, idx, mask.cpu())


def _index_pair(cuda, mode, n_docs=3000, V=2000, seed=0):
    """The same corpus indexed on the CPU and on the card (bf16 weights,
    l_max 64, two-phase on 8 terms a doc or terms >= 0.4 max)."""
    from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig, SparseIndex

    rng = np.random.default_rng(seed)
    tok = rng.integers(0, V, size=(n_docs, 64)).astype(np.int32)
    w = np.sort(rng.gamma(2.0, 1.0, size=(n_docs, 64)).astype(np.float32), axis=1)[:, ::-1]
    out = []
    for dev in ("cpu", cuda):
        idx = SparseIndex(V, IndexConfig(engine="sparse", l_max=64, block_docs=512,
                                         query_batch=16, two_phase_mode=mode,
                                         two_phase_terms=8), device=dev)
        idx.add_topk([f"d{i}" for i in range(n_docs)], tok, np.ascontiguousarray(w))
        idx.finalize()
        out.append(idx)
    q_tok = rng.integers(0, V, size=(40, 8)).astype(np.int32)
    q_w = rng.gamma(2.0, 1.0, size=(40, 8)).astype(np.float32)
    q_tok[:, 1] = q_tok[:, 0]  # duplicates sum
    q_w[::4, 7] = 0.0
    return out, q_tok, q_w


def _same_hits(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert list(g) == list(r)  # one sum order per doc on both devices up to fp32 noise
        np.testing.assert_allclose(list(g.values()), list(r.values()), rtol=1e-6)


@pytest.mark.parametrize("mode", ["query", "doc"])
def test_search_tokens_and_two_phase_on_the_card_equal_the_cpu(cuda, mode):
    (cpu, card), q_tok, q_w = _index_pair(cuda, mode)
    for kw in (dict(), dict(two_phase=True), dict(query_prune=0.3)):
        _same_hits(card.search_tokens(q_tok, q_w, k=10, **kw),
                   cpu.search_tokens(q_tok, q_w, k=10, **kw))
    assert card.last_certified is None


def test_out_of_range_token_ids_on_the_card_do_not_assert(cuda):
    (cpu, card), q_tok, q_w = _index_pair(cuda, "query")
    q_tok[:, 2] = 2000 + np.arange(40)  # >= V
    q_tok[:, 3] = -5000  # below -V
    got = card.search_tokens(q_tok, q_w, k=10)
    torch.cuda.synchronize()  # a device-side assert would surface here
    _same_hits(got, cpu.search_tokens(q_tok, q_w, k=10))
    assert torch.ones(1, device=cuda).item() == 1.0  # the context still works


# ------------------------------------------------- the inverted engine


def _inverted_pair(cuda, n_docs=3000, V=3000, seed=0, **kw):
    """One zipf-popular corpus in an inverted index on the CPU and on the
    card (built there by the incremental build, the default on CUDA)."""
    from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig, SparseIndex

    rng = np.random.default_rng(seed)
    pop = np.arange(1, V + 1, dtype=np.float64) ** -1.1
    tok = np.minimum(np.searchsorted(np.cumsum(pop / pop.sum()), rng.random((n_docs, 48))),
                     V - 1).astype(np.int32)
    w = rng.gamma(2.0, 0.5, size=(n_docs, 48)).astype(np.float32)
    tok.sort(axis=1)
    w[:, 1:][tok[:, 1:] == tok[:, :-1]] = 0.0
    order = np.argsort(-w, axis=1, kind="stable")
    tok, w = np.take_along_axis(tok, order, 1), np.take_along_axis(w, order, 1)
    tok[w <= 0] = 0
    out = []
    for dev in ("cpu", cuda):
        cfg = IndexConfig(engine="inverted", l_max=48, block_docs=512, query_batch=16,
                          weight_dtype="float32", **kw)
        idx = SparseIndex(V, cfg, device=dev)
        for s in range(0, n_docs, 500):
            idx.add_topk([f"d{i}" for i in range(s, s + 500)], tok[s:s + 500], w[s:s + 500])
        idx.finalize()
        out.append(idx)
    assert out[1].postings_source == "incremental" and out[0].postings_source == "one-shot"
    np.testing.assert_array_equal(out[1]._post_docs.cpu().numpy(), out[0]._post_docs.numpy())
    q_tok = np.zeros((40, 8), np.int32)
    q_w = np.zeros((40, 8), np.float32)
    for i in range(39):  # terms of one doc; the last row is padding
        row = np.unique(tok[rng.integers(0, n_docs)])
        pick = rng.choice(row[row > 0], size=6, replace=False)
        q_tok[i, :6], q_w[i, :6] = pick, rng.uniform(1.0, 5.0, size=6)
    return out, q_tok, q_w, V


def _close_hits(got, ref, rtol=1e-5):
    """The same docs above the k-th score's tie band, scores to rtol."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g) == len(r)
        np.testing.assert_allclose(sorted(g.values()), sorted(r.values()), rtol=rtol)
        if r:
            edge = min(r.values()) * (1 + rtol)
            assert {d for d, s in g.items() if s > edge} == {d for d, s in r.items() if s > edge}


def _same_flags(card, cpu, band):
    for a, b in ((card.last_certified, cpu.last_certified),
                 (card.last_escalated, cpu.last_escalated),
                 (card.last_scan_escalated, cpu.last_scan_escalated)):
        assert (a is None) == (b is None)
        if a is not None:
            assert ((a == b) | band).all()


_INVERTED_MODES = {
    "tokens": dict(postings_cap=16, exact_escalate=True),
    "dense": dict(postings_cap=16, exact_escalate=True),
    "full": dict(postings_cap=32, postings_ext_cap=96, full_query_terms=8,
                 full_postings_cols=8, exact_escalate=True),
    "two_phase": dict(postings_cap=16, exact_escalate=True),
    "deep_blockmax_refine": dict(postings_cap=8, postings_ext_cap=120, tail_block_docs=512,
                                 refine_expand=4, exact_escalate=True),
    "no_escalation": dict(postings_cap=16),
}


@pytest.mark.parametrize("mode", list(_INVERTED_MODES))
def test_inverted_engine_on_the_card_equals_the_cpu(cuda, mode):
    """Each mode of the inverted engine gives the CPU's answers on the card,
    and the same stage codes except on rows at the certificate's edge."""
    (cpu, card), q_tok, q_w, V = _inverted_pair(cuda, **_INVERTED_MODES[mode])
    q = cpu._token_query(q_tok, q_w)
    if mode == "full":
        q[:, :40] += 0.01  # 40 more active terms: wider than query_terms
    kw = dict(two_phase=True) if mode == "two_phase" else {}
    if mode == "tokens":
        got, ref = card.search_tokens(q_tok, q_w, k=10), cpu.search_tokens(q_tok, q_w, k=10)
        engine, qb = "inverted_tokens", (torch.from_numpy(np.pad(q_tok, ((0, 0), (0, 8)))),
                                         torch.from_numpy(np.pad(q_w, ((0, 0), (0, 8)))))
    else:
        got, ref = card.search(q.to(cuda), k=10, **kw), cpu.search(q, k=10, **kw)
        engine, qb = ("inverted_full" if mode == "full" else "inverted"), q
    torch.cuda.synchronize()
    _close_hits(got, ref)
    fns = cpu._inverted_fns(10, bool(kw), engine)
    band = np.zeros(40, bool)
    for fn in (fns.base, fns.deep):
        if fn is not None:
            s, _, b = fn(qb)
            kth, b = s[:, -1].numpy(), b.numpy()
            with np.errstate(invalid="ignore"):
                band |= np.abs(kth - b) <= 2e-4 * np.maximum(np.abs(kth), np.abs(b))
    _same_flags(card, cpu, band)
    if mode != "no_escalation" and mode != "two_phase":
        assert card.last_certified.all()


def test_certificate_bound_takes_no_tf32(cuda):
    """The bound's total-mass term is fp32 elementwise products and an fp32
    sum, not a matmul: with TF32 allowed it is the same as the CPU's, and
    an index on the card leaves TF32 off."""
    from opensearch_sparse_model_tuning_sample_torch.index import inverted

    (cpu, card), q_tok, q_w, V = _inverted_pair(cuda, postings_cap=16)
    assert not torch.backends.cuda.matmul.allow_tf32
    q = cpu._token_query(q_tok, q_w)
    q[:, :300] += 0.3  # mass outside the lookup slots
    outs = []
    for idx, qq in ((cpu, q), (card, q.to(cuda))):
        fn = inverted.make_search_fn(idx._post_docs, idx._post_w, idx._tok_dev, idx._docs_dev,
                                     query_terms=16, k=10, with_bound=True)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            outs.append([x.cpu() for x in fn(qq, idx._post_docs, idx._post_w, idx._tok_dev,
                                             idx._docs_dev)])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    np.testing.assert_allclose(outs[1][2].numpy(), outs[0][2].numpy(), rtol=1e-6)
    np.testing.assert_allclose(outs[1][0].numpy(), outs[0][0].numpy(), rtol=1e-6)


def test_inverted_out_of_range_token_ids_on_the_card_do_not_assert(cuda):
    (cpu, card), q_tok, q_w, V = _inverted_pair(cuda, postings_cap=16, exact_escalate=True)
    q_tok[:, 6] = V + np.arange(40)
    q_tok[:, 7] = -V - 7
    q_w[:, 6:] = 2.0
    got = card.search_tokens(q_tok, q_w, k=10)
    torch.cuda.synchronize()
    _close_hits(got, cpu.search_tokens(q_tok, q_w, k=10))
    assert torch.ones(1, device=cuda).item() == 1.0


# ---- the device mesh inside one process (core/mesh.py) ---------------------


def _mesh_pair(cuda, shard_by, **kw):
    """The same corpus on a four-position mesh on the CPU and on a
    four-position mesh on one card (make_mesh(devices=["cuda:0"] * 4))."""
    from opensearch_sparse_model_tuning_sample_torch.core.mesh import make_mesh
    from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig, SparseIndex

    (cpu1, _), q_tok, q_w, V = _inverted_pair(cuda, postings_cap=16)
    n = cpu1.n_docs
    toks, ws = cpu1._tok_dev[:n].numpy().astype(np.int32), cpu1._docs_dev[:n].numpy()
    out = []
    for dev in ("cpu", f"cuda:{torch.cuda.current_device()}"):
        cfg = IndexConfig(l_max=48, block_docs=256, query_batch=16, weight_dtype="float32",
                          shard_by=shard_by, two_phase_mode="doc", two_phase_terms=8, **kw)
        idx = SparseIndex(V, cfg, mesh=make_mesh(devices=[dev] * 4))
        idx.add_topk([f"d{i}" for i in range(n)], toks, ws)
        idx.finalize()
        assert len(idx._stripes) == 4
        out.append(idx)
    return out, q_tok, q_w


_MESH_MODES = {
    "scan": dict(engine="sparse"),
    "two_phase_doc": dict(engine="sparse"),
    "inverted_escalation": dict(engine="inverted", postings_cap=16, exact_escalate=True),
}


@pytest.mark.parametrize("shard_by", ["docs", "queries"])
@pytest.mark.parametrize("mode", list(_MESH_MODES))
def test_mesh_on_the_card_equals_the_mesh_on_the_cpu(cuda, mode, shard_by):
    """Doc- and query-sharded layouts over four positions of one card answer
    as the same mesh on the CPU: the scan, per-stripe two-phase and the
    inverted engine with the host escalation (every row certified)."""
    (cpu, card), q_tok, q_w = _mesh_pair(cuda, shard_by, **_MESH_MODES[mode])
    assert all(st.device.type == "cuda" for st in card._stripes)
    kw = dict(two_phase=True) if mode == "two_phase_doc" else {}
    got = card.search_tokens(q_tok, q_w, k=10, **kw)
    torch.cuda.synchronize()
    ref = cpu.search_tokens(q_tok, q_w, k=10, **kw)
    if mode == "inverted_escalation":
        _close_hits(got, ref)
        assert card.last_certified.all() and cpu.last_certified.all()
        np.testing.assert_array_equal(card.last_escalated, card.last_scan_escalated)
    else:
        _same_hits(got, ref)


def test_mesh_whose_device_disagrees_raises(cuda):
    from opensearch_sparse_model_tuning_sample_torch.core.mesh import make_mesh
    from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig, SparseIndex

    mesh = make_mesh(devices=[cuda] * 2)
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        SparseIndex(100, IndexConfig(), mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        SparseIndex(100, IndexConfig(), mesh=make_mesh(devices=["cpu"] * 2), device=cuda)
    assert SparseIndex(100, IndexConfig(), mesh=mesh, device=cuda).device == mesh.devices[0]


# ---- knowledge distillation: teachers on the card (train/teachers.py) -----


def _teacher_feats(V, B, L, seed, device, pad_id=0):
    """Seeded token ids (no tokenizer files) with right padding; the first
    row full."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, V, size=(B, L))
    lens = rng.integers(2, L + 1, size=B)
    lens[0] = L
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    ids = np.where(mask > 0, ids, pad_id)
    return {"input_ids": torch.from_numpy(ids).to(device),
            "attention_mask": torch.from_numpy(mask).to(device)}


def _minmax_atol(raw, rel, scale):
    """The ensemble scores' tolerance: a raw-score error of `rel` max|s|
    becomes 2 rel max|s| / range after a row's min-max, averaged over the
    teachers, times the score scale."""
    per = [2 * rel * np.abs(s).max(1) / (s.max(1) - s.min(1)) for s in raw]
    return scale * np.mean(per, axis=0)[:, None]


@pytest.mark.parametrize("in_batch", [False, True], ids=["grouped", "in_batch"])
def test_teacher_reps_and_ensemble_scores_on_the_card_equal_the_cpu(cuda, in_batch):
    """Two sparse teachers (the ingest kernel) and a dense one, built from
    the same seeds on both devices: reps within bf16 rounding (3e-2), and
    the ensemble's fp32 scores within that carried through the min-max."""
    from opensearch_sparse_model_tuning_sample_torch.train import teachers as tt

    kinds = (("sparse", "cls"), ("sparse", "cls"), ("dense", "mean"))
    ens = {dev: tt.TeacherEnsemble(
        [tt.build_teacher(k, "mini", seed=10 + i, pooling=p, device=dev)
         for i, (k, p) in enumerate(kinds)], use_in_batch_negatives=in_batch)
        for dev in ("cpu", cuda)}
    B, G = 6, 3
    feats = {dev: ([_teacher_feats(30522, B, 32, seed=i, device=dev) for i in range(3)],
                   [_teacher_feats(30522, B * G, 64, seed=9 + i, device=dev) for i in range(3)])
             for dev in ("cpu", cuda)}
    raw = []
    for i, (t_cpu, t_card) in enumerate(zip(ens["cpu"].teachers, ens[cuda].teachers)):
        reps = {}
        for dev, t in (("cpu", t_cpu), (cuda, t_card)):
            reps[dev] = [tt.teacher_rep(t, f[i]).cpu().double().numpy() for f in feats[dev]]
        for got, want in zip(reps[cuda], reps["cpu"]):
            np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)
        q, d = reps["cpu"]
        raw.append(q @ d.T if in_batch else np.einsum("bgv,bv->bg", d.reshape(B, G, -1), q))
    got = ens[cuda].get_scores(*feats[cuda]).cpu().numpy()
    want = ens["cpu"].get_scores(*feats["cpu"]).numpy()
    assert got.shape == want.shape == ((B, B * G) if in_batch else (B, G))
    assert (np.abs(got - want) <= _minmax_atol(raw, 3e-2, 30.0)).all()


def test_teacher_forward_launches_the_ingest_kernel_only(cuda):
    """A sparse teacher's forward, even with grad mode on as in a train
    step, launches the ingest kernel once and no training kernel or plain
    version; its output carries no graph."""
    from opensearch_sparse_model_tuning_sample_torch.train import teachers as tt

    t = tt.build_teacher("sparse", "mini", seed=3, device=cuda)
    assert not any(p.requires_grad for p in t.bert.parameters()) and not t.bert.training
    kernels = (maxpool_head, mp.maxpool_head_argmax, mp.maxpool_head_bwd_w, mp.maxpool_head_bwd_h,
               mp.maxpool_head_bwd_buckets)
    plains = (maxpool_head_reference, mp.maxpool_head_argmax_reference,
              mp.maxpool_head_bwd_w_reference, mp.maxpool_head_bwd_h_reference,
              mp.bucket_by_argmax_reference)
    before = [_launches(f) for f in kernels] + [_calls(f) for f in plains]
    with torch.enable_grad():
        rep = tt.teacher_rep(t, _teacher_feats(30522, 12, 64, seed=1, device=cuda))
    torch.cuda.synchronize()
    after = [_launches(f) for f in kernels] + [_calls(f) for f in plains]
    assert [a - b for a, b in zip(after, before)] == [1] + [0] * 9
    assert not rep.requires_grad and rep.grad_fn is None


@pytest.mark.parametrize("layout", ["roberta", "distilbert"])
def test_roberta_and_distilbert_teachers_on_the_card_equal_the_cpu(cuda, layout, tmp_path):
    """A checkpoint of each layout written by the port's save_checkpoint
    from seeded weights and loaded back: sparse reps (RoBERTa's vocab
    50 265 padded to 50 304 through the ingest kernel) and dense reps on
    the card within bf16 rounding (3e-2) of the CPU's."""
    from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert
    from opensearch_sparse_model_tuning_sample_torch.models import hf_import
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
    from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import load_tokenizer
    from opensearch_sparse_model_tuning_sample_torch.ops.activations import special_token_mask
    from opensearch_sparse_model_tuning_sample_torch.train import teachers as tt

    layouts = {
        "roberta": dict(model_type="roberta", vocab_size=50265, position_style="from_pad_offset",
                        head_act="gelu", max_position_embeddings=514, type_vocab_size=1,
                        pad_token_id=1, layer_norm_eps=1e-5),
        "distilbert": dict(model_type="distilbert", vocab_size=30522, use_token_type=False,
                           type_vocab_size=1),
    }
    cfg = tbert.config_from_preset("tiny", **layouts[layout])
    model = tse.SparseEncoderModel(cfg, tbert.from_state_dict(cfg, tbert.init_state_dict(cfg, 4),
                                                              torch.device("cpu")),
                                   torch.ones(cfg.vocab_size), load_tokenizer(None))
    hf_import.save_checkpoint(model, str(tmp_path))
    cfg2, sd, _ = hf_import.load_checkpoint(str(tmp_path))
    assert cfg2.model_type == layout and cfg2.padded_vocab_size == cfg.padded_vocab_size
    reps = {}
    for dev in ("cpu", cuda):
        bert = tbert.from_state_dict(cfg2, sd, torch.device(dev)).requires_grad_(False)
        smask = special_token_mask([0, 1, 2], cfg2.vocab_size, torch.device(dev))
        f = _teacher_feats(cfg2.vocab_size, 8, 64, seed=5, device=dev, pad_id=cfg2.pad_token_id)
        reps[dev] = [tt.sparse_teacher_rep(bert, smask, f["input_ids"], f["attention_mask"])]
        reps[dev] += [tt.dense_teacher_rep(bert, f["input_ids"], f["attention_mask"], pooling=p)
                      for p in ("cls", "mean")]
    for got, want in zip(reps[cuda], reps["cpu"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=3e-2, rtol=3e-2)


def _world_one_env():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def test_nccl_at_world_one_gathers_and_sums_cuda_tensors(cuda):
    """The process group on the card is NCCL; at world size 1 the gather is
    the identity with a slice backward, and the gradient sum leaves the
    gradients as they are (a parameter without one gets zeros)."""
    from opensearch_sparse_model_tuning_sample_torch.core import distributed
    from opensearch_sparse_model_tuning_sample_torch.parallel import collectives

    assert distributed.maybe_init_distributed("cuda:0", timeout_s=120, env=_world_one_env())
    try:
        assert distributed.backend() == "nccl" and distributed.world_size() == 1
        x = torch.randn(4, 8, device=cuda, requires_grad=True)
        y = collectives.all_gather_batch(x)
        assert y.is_cuda and torch.equal(y, x.detach())
        (3 * y).sum().backward()
        assert torch.equal(x.grad, torch.full_like(x, 3.0))
        with torch.no_grad():
            assert torch.equal(collectives.all_gather_batch(x * 2), x.detach() * 2)
        p = torch.nn.Parameter(torch.randn(5, device=cuda))
        q = torch.nn.Parameter(torch.randn(2, 3, device=cuda))
        p.grad = torch.arange(5.0, device=cuda)
        collectives.all_reduce_grads([p, q])
        assert torch.equal(p.grad, torch.arange(5.0, device=cuda))
        assert torch.equal(q.grad, torch.zeros_like(q))
        distributed.barrier()
    finally:
        distributed.destroy()


def test_data_parallel_step_at_world_one_equals_the_one_process_step(cuda, tmp_path):
    """Two train steps of the tiny model with dropout on, under an NCCL
    group of one and without a group: the losses agree to 1e-5 relative
    (one card; the attention backward may sum in another order run to run)
    and the step went through the gather and the gradient sum."""
    from opensearch_sparse_model_tuning_sample_torch.core import config, distributed
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
    from opensearch_sparse_model_tuning_sample_torch.parallel import collectives
    from opensearch_sparse_model_tuning_sample_torch.train.trainer import Trainer

    ma, da, ta = config.parse_config({
        "arch": "tiny", "loss_types": ["infonce"], "use_in_batch_negatives": True,
        "learning_rate": 1e-3, "max_steps": 2, "warmup_steps": 0, "save_strategy": "no",
        "output_dir": str(tmp_path / "out"), "device": "cuda:0"})
    rng = np.random.default_rng(0)
    batch = {"q_input_ids": rng.integers(1000, 5000, (4, 8)),
             "q_attention_mask": np.ones((4, 8), np.int64),
             "d_input_ids": rng.integers(1000, 5000, (8, 16)),
             "d_attention_mask": np.ones((8, 16), np.int64)}
    losses = {}
    for group in (False, True):
        if group:
            assert distributed.maybe_init_distributed("cuda:0", timeout_s=120,
                                                      env=_world_one_env())
        try:
            collectives.reset_counts()
            model = tse.from_model_args(ma, seed=0, device=cuda)
            trainer = Trainer(model, ma, da, ta)
            losses[group] = [float(trainer.train_step(batch)["loss"]) for _ in range(2)]
            assert trainer.distributed is group
            assert collectives.counts() == ({"all_gather_batch": 4, "all_reduce_grads": 2}
                                            if group else
                                            {"all_gather_batch": 0, "all_reduce_grads": 0})
        finally:
            distributed.destroy()
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5)


def test_mesh_train_step_on_the_card_matches_one_position(cuda, tmp_path):
    """Two train steps of the tiny model (dropout off) over a mesh of four
    positions on the card against the same steps at one position on the
    global batch: the first step's loss to 1e-3 relative (bf16 encoders at
    other GEMM shapes, as chip_smoke's step 13 holds it), each training
    kernel launched once per position, the mesh's collectives run, and
    every replica bit-equal to the model after each step."""
    import dataclasses

    from opensearch_sparse_model_tuning_sample_torch.core import config
    from opensearch_sparse_model_tuning_sample_torch.core.mesh import make_mesh
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
    from opensearch_sparse_model_tuning_sample_torch.ops import maxpool as mp
    from opensearch_sparse_model_tuning_sample_torch.parallel import collectives
    from opensearch_sparse_model_tuning_sample_torch.train.trainer import Trainer

    ma, da, ta = config.parse_config({
        "arch": "tiny", "loss_types": ["infonce"], "use_in_batch_negatives": True,
        "learning_rate": 1e-3, "max_steps": 2, "warmup_steps": 0, "save_strategy": "no",
        "output_dir": str(tmp_path / "out")})
    rng = np.random.default_rng(0)
    batch = {"q_input_ids": rng.integers(1000, 5000, (8, 8)),
             "q_attention_mask": np.ones((8, 8), np.int64),
             "d_input_ids": rng.integers(1000, 5000, (16, 16)),
             "d_attention_mask": np.ones((16, 16), np.int64)}
    losses = {}
    for n in (4, 1):
        model = tse.from_model_args(ma, seed=0, device=cuda)
        cfg = dataclasses.replace(model.cfg, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0)
        for m in model.modules():
            if hasattr(m, "cfg"):
                m.cfg = cfg
        trainer = Trainer(model, ma, da, ta, mesh=make_mesh(devices=[cuda] * n))
        collectives.reset_counts()
        mp.reset_launch_counts()
        losses[n] = []
        for _ in range(2):
            losses[n].append(float(trainer.train_step(batch)["loss"]))
            lead = dict(model.named_parameters())
            for r in trainer.replicas:
                assert all(torch.equal(p, lead[k]) for k, p in r.named_parameters())
        assert (_launches(mp.maxpool_head_argmax), _launches(mp.maxpool_head_bwd_w),
                _launches(mp.maxpool_head_bwd_h)) == (2 * n,) * 3
        assert collectives.mesh_counts()["mesh_grad_sum"] == (2 if n > 1 else 0)
    np.testing.assert_allclose(losses[4][0], losses[1][0], rtol=1e-3)


# ---- ingest: length-sorted chunks (models/sparse_encoder.py) -------------

_WORDS = ("the capital of france is paris machine learning on tensor processing units sparse "
          "retrieval uses inverted indexes bert computes contextual token representations "
          "protein cell gene expression study patients treatment results effect").split()


def _row_gap(toks, w, ref, l_max):
    """The benchmark's row_gap rule (lsr_bench's ingest check): per doc, the
    widest of |stored weight - reference's (rounded to bfloat16)| over the
    stored terms and the reference weight by which an unstored term beats
    a stored one (any unstored term's where fewer than l_max are stored),
    over the doc's largest reference weight; the widest over the docs."""
    prog = torch.zeros_like(ref).scatter_reduce_(1, toks, w, "amax")
    kept = prog > 0
    val = torch.where(kept, (prog - ref.to(torch.bfloat16).float()).abs(), 0.0).amax(1)
    rmin = torch.where(kept, ref, float("inf")).amin(1)
    out_max = torch.where(kept, 0.0, ref).amax(1)
    sel_gap = torch.where(kept.sum(1) >= l_max, torch.relu(out_max - rmin), out_max)
    return float((torch.maximum(val, sel_gap) / ref.amax(1).clamp_min(1e-30)).max())


def test_length_sorted_ingest_on_the_card_matches_docs_encoded_alone(cuda, tmp_path):
    """A corpus of lognormal lengths (some past max_length) ingested on the
    card, its chunks' batches each at its own length, against the same
    docs encoded one at a time: the stored rows, read back in corpus
    order, within the benchmark's row_gap limit (0.035), and some batches
    below the chunk's bucket."""
    import json

    from opensearch_sparse_model_tuning_sample_torch.eval.beir import ingest
    from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    rng = np.random.default_rng(17)
    lens = np.clip(rng.lognormal(np.log(178), 0.6, size=230), 20, 700).astype(int)
    corpus = [(f"d{i}", " ".join(rng.choice(_WORDS, n))) for i, n in enumerate(lens)]
    model = tse.build_model(arch="mini", idf_path="assets/idf.npz", seed=0, device=cuda)
    l_max = 64
    tracing.reset([k for k in tracing.counters() if k.startswith("encoder.batch_len.")]
                  + ["encoder.copy_out.async"])
    index = ingest(corpus, model, str(tmp_path), "t", max_length=512, batch_size=10,
                   index_cfg=IndexConfig(engine="sparse", l_max=l_max))
    by_len = {k: v for k, v in tracing.counters().items() if k.startswith("encoder.batch_len.")}
    assert sum(v for k, v in by_len.items() if not k.endswith(".512")) > 0, by_len
    # every chunk of 80 docs resolved through its own event
    assert tracing.counters()["encoder.copy_out.async"] == -(-len(corpus) // 80)
    index.save(str(tmp_path / "saved"))
    blob = np.load(tmp_path / "saved" / "index.npz")
    w = (blob["weights_bf16"].astype(np.uint32) << 16).view(np.float32) \
        if "weights_bf16" in blob else blob["weights"].astype(np.float32)
    with open(tmp_path / "saved" / "doc_ids.json") as f:
        assert json.load(f) == [d for d, _ in corpus]  # stored in corpus order
    enc = tse.BatchEncoder(model, max_length=512)
    ref = torch.cat([enc.encode_batch_device([t]) for _, t in corpus])
    n = len(corpus)  # the rows past the docs are the index's spare capacity
    gap = _row_gap(torch.from_numpy(blob["tokens"][:n].astype(np.int64)).to(cuda),
                   torch.from_numpy(w[:n]).to(cuda), ref, l_max)
    assert gap < 0.035, gap


def _mixed_chunks(seed, sizes=(37, 80, 13, 80)):
    """Chunks of docs of lognormal lengths (some past 512 tokens)."""
    rng = np.random.default_rng(seed)
    return [[" ".join(rng.choice(_WORDS, k))
             for k in np.clip(rng.lognormal(np.log(178), 0.6, size=n), 3, 700).astype(int)]
            for n in sizes]


def test_chunk_encode_and_resolve_make_no_stream_sync(cuda):
    """Ingest's chunk path on the card queues its copies in and out without
    an implicit sync of the stream: under the sync debug mode's "error", a
    chunk is encoded and the one before it resolved, as `ingest` does."""
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse

    model = tse.build_model(arch="mini", idf_path="assets/idf.npz", seed=0, device=cuda)
    enc = tse.BatchEncoder(model, max_length=512)
    chunks = _mixed_chunks(23)
    enc.resolve_chunk_sparse(*enc.encode_chunk_sparse_async(chunks[0], l_max=64, rows=10))
    torch.cuda.synchronize()
    first = enc.encode_chunk_sparse_async(chunks[0], l_max=64, rows=10)
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = enc.encode_chunk_sparse_async(chunks[1], l_max=64, rows=10)
        enc.resolve_chunk_sparse(*first)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    enc.resolve_chunk_sparse(*second)


def test_chunks_resolved_late_equal_chunks_resolved_at_once(cuda):
    """Four chunks of mixed lengths queued in turn: the second to fourth
    each resolved after the next was queued (ingest's order), the first
    only after the other three had run and been resolved. Each gives, bit
    for bit, the rows it gave resolved at once and the rows the blocking
    copy of its own device tensors gives; and the rows returned at once
    are unchanged after all of that, so no returned array shares a host
    buffer that the allocator handed out again."""
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    model = tse.build_model(arch="mini", idf_path="assets/idf.npz", seed=0, device=cuda)
    enc = tse.BatchEncoder(model, max_length=512)
    chunks = _mixed_chunks(29)

    def blocking(handle, nv):  # the copy back as it was made before the events
        sel = handle[3][:nv]
        return handle[0].cpu().numpy()[sel], handle[1].cpu().numpy()[sel]

    at_once = [enc.resolve_chunk_sparse(*enc.encode_chunk_sparse_async(c, l_max=64, rows=10))
               for c in chunks]
    kept = [(i.copy(), w.copy()) for i, w in at_once]
    tracing.reset(["encoder.copy_out.async"])
    first = enc.encode_chunk_sparse_async(chunks[0], l_max=64, rows=10)
    late, prev = {}, None
    for j in (1, 2, 3):
        handle = enc.encode_chunk_sparse_async(chunks[j], l_max=64, rows=10)
        if prev is not None:
            late[j - 1] = (enc.resolve_chunk_sparse(*prev), blocking(*prev))
        prev = handle
    late[3] = (enc.resolve_chunk_sparse(*prev), blocking(*prev))
    late[0] = (enc.resolve_chunk_sparse(*first), blocking(*first))
    assert tracing.counters()["encoder.copy_out.async"] == 4
    for j, ((gi, gw), (bi, bw)) in late.items():
        ri, rw = at_once[j]
        assert gi.shape == (len(chunks[j]), 64)
        for got in (gi, bi):
            np.testing.assert_array_equal(got, ri)
        for got in (gw, bw):
            np.testing.assert_array_equal(got, rw)
    for (ri, rw), (ki, kw) in zip(at_once, kept):
        np.testing.assert_array_equal(ri, ki)
        np.testing.assert_array_equal(rw, kw)


# --------------------------------------------------------------------------
# ModernBERT's fused attention (ops/attention.py) and its head at D = 1 024


def _attn_inputs(B, L, H, hd, seed, device, holey=False):
    """q, k, v [B, L, H, hd] bf16 as views of one qkv tensor (the model's
    layout) and a mask: rows of lengths drawn in [1, L], one row full, and
    with `holey` a row with interior holes."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv = torch.randn((B, L, 3, H, hd), generator=g).to(device, torch.bfloat16)
    lens = torch.randint(1, L + 1, (B,), generator=g)
    lens[0] = L
    mask = (torch.arange(L)[None, :] < lens[:, None]).to(torch.int32)
    if holey and B > 1:
        mask[1, torch.randperm(L, generator=g)[: L // 3]] = 0
        mask[1, 0] = 1
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask.to(device)


@pytest.mark.parametrize("B,L,holey", [(8, 8192, False), (3, 1000, True), (2, 4417, False),
                                       (5, 65, True)], ids=["8x8192", "odd1000", "odd4417",
                                                           "odd65"])
@pytest.mark.parametrize("window", [0, 64], ids=["global", "local"])
def test_fused_attention_matches_the_plain_masked_path(cuda, B, L, holey, window):
    """The kernel against the plain version on the live query rows (a
    padding row's values are unused), each (query, head) row held to its
    own scale. Both sum exact bf16 products in fp32 and round the
    probabilities to bf16 before ·v (the kernel's unnormalised, relative to
    the running max; the plain one's normalised): two independent roundings
    of 2^-8 each on a weighted mean of v. Both round the output to bf16,
    another 2^-8 each. So a row's relative L2 gap is about 2^-8: the worst
    row within 2^-6, the mean within 2^-7. A key tile of 64 dropped from a
    row of 4 480 live keys moves it by about 12 %, and one dropped from a
    window of 129 keys by half. The launch adds `computed_pairs` to its
    counter and its kernel's name to the launch counts, and allocates its
    output alone, no [L, L] tensor."""
    from opensearch_sparse_model_tuning_sample_torch.ops import attention as at
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    q, k, v, mask = _attn_inputs(B, L, 16, 64, 1000 + L + window, cuda, holey)
    kind = "local" if window else "global"
    launches = "attn.launches.attention_" + ("window" if window else "global") + "_kernel"
    tracing.reset(["encoder.attn.pairs." + kind, launches])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = at.attention(q, k, v, mask, window)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= got.numel() * got.element_size() + (1 << 20)
    c = tracing.counters()
    assert c["encoder.attn.pairs." + kind] == at.computed_pairs(B, L, window)
    assert c[launches] == 1
    ref = at.attention_reference(q, k, v, mask, window)
    assert bool(torch.isfinite(got.float()).all())
    live = mask.bool()
    g, r = got.float()[live], ref.float()[live]  # [live rows, H, hd]
    rel = (g - r).norm(dim=-1) / r.norm(dim=-1)
    assert float(rel.max()) <= 2 ** -6, float(rel.max())
    assert float(rel.mean()) <= 2 ** -7, float(rel.mean())


def test_head_kernel_at_modernbert_width_matches_plain(cuda):
    """The ingest head kernel at D = 1 024 (its narrowest plan), L = 8 192
    and ModernBERT's padded vocab (50 432 columns) against its plain
    version, as `_check` holds the other shapes."""
    _check(*_inputs(2, 8192, 1024, 50432, 31, cuda))


def test_tiny_modernbert_on_the_card_matches_the_cpu(cuda):
    """encode_doc of a ModernBERT at test widths (two periods, head dim 16)
    on the card (the attention and head kernels) against the CPU (their
    plain versions), bf16 compute on both: the reps within the rounding of
    bf16 products summed in another order (2e-2 of each row's largest)."""
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse

    g = torch.Generator().manual_seed(5)
    ids = torch.randint(5, 512, (4, 200), generator=g)
    mask = (torch.arange(200)[None, :] < torch.tensor([200, 150, 64, 7])[:, None]).int()
    reps = []
    for dev in (cuda, torch.device("cpu")):
        model = tse.build_model(arch="modernbert-tiny", seed=3, device=dev)
        with torch.no_grad():
            reps.append(tse.encode_doc(model, ids.to(dev), mask.to(dev)).cpu())
    scale = reps[1].abs().amax(1, keepdim=True)
    assert bool(((reps[0] - reps[1]).abs() <= 2e-2 * scale).all())


# ---- BERT's attention through the fused kernel (models/bert.py) ----------

_BERT_ATTN = ("attn.launches.attention_global_kernel", "encoder.attn.plain_chain")


def _bert_attn_counts():
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    c = tracing.counters()
    return [c.get(n, 0) for n in _BERT_ATTN]


def _row_gaps(got, ref, live):
    """Per live position, |got - ref| / |ref| over the hidden axis."""
    g, r = got[live].float(), ref[live].float()
    return (g - r).norm(dim=-1) / r.norm(dim=-1)


@pytest.mark.parametrize("L", [128, 192, 320, 512])
def test_distilbert_inference_on_the_card_takes_the_fused_kernel(cuda, L):
    """A DistilBERT-width BertForMaskedLM on the card under inference_mode at
    a sorted chunk's batch shape [50, L] (live lengths from L / 2 to L, one
    row full) launches the fused kernel once a layer and takes no plain
    chain; the same model with grad on (no dropout) takes the plain chain
    in every layer and launches nothing. The pooled reps of the two agree
    within the card's encoder tolerance (2e-2 of each row's largest, as the
    teachers' and ModernBERT's card tests hold them), and the fused path
    drops no precision: against the same weights computing in float32, its
    hidden states are as close as the plain chain's, per live position
    (the mean relative gap within 5 % of the plain chain's, the worst within
    25 %). Two bf16 paths that round in other places each sit about 0.9 %
    from float32 per position here, with single values up to 2 % of the
    largest |h| apart, so no tighter bound on their difference is sound."""
    import dataclasses

    from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert

    cfg = tbert.config_from_preset("distill", model_type="distilbert", use_token_type=False,
                                   type_vocab_size=1)
    sd = tbert.init_state_dict(cfg, seed=21)
    model = tbert.from_state_dict(cfg, sd, cuda)
    fp32 = tbert.from_state_dict(dataclasses.replace(cfg, compute_dtype=torch.float32), sd, cuda)
    g = torch.Generator().manual_seed(L)
    ids = torch.randint(1000, cfg.vocab_size, (50, L), generator=g)
    lens = torch.randint(L // 2, L + 1, (50,), generator=g)
    lens[0] = L
    mask = (torch.arange(L)[None, :] < lens[:, None]).long()
    ids, mask = ids.to(cuda), mask.to(cuda)
    live = mask.bool()
    before = _bert_attn_counts()
    with torch.inference_mode():
        fused = model.encode_hidden(ids, mask)
        fused_rep = model.mlm_maxpool(fused, mask)
    torch.cuda.synchronize()
    mid = _bert_attn_counts()
    assert [a - b for a, b in zip(mid, before)] == [cfg.num_hidden_layers, 0]
    plain = model.encode_hidden(ids, mask)
    assert plain.requires_grad
    assert [a - b for a, b in zip(_bert_attn_counts(), mid)] == [0, cfg.num_hidden_layers]
    plain = plain.detach()
    with torch.inference_mode():
        plain_rep = model.mlm_maxpool(plain, mask)
        exact = fp32.encode_hidden(ids, mask)
    scale = plain_rep.abs().amax(1, keepdim=True)
    assert bool(((fused_rep - plain_rep).abs() <= 2e-2 * scale).all())
    f, p = _row_gaps(fused, exact, live), _row_gaps(plain, exact, live)
    assert float(f.mean()) <= 1.05 * float(p.mean()), (float(f.mean()), float(p.mean()))
    assert float(f.max()) <= 1.25 * float(p.max()), (float(f.max()), float(p.max()))


def test_training_step_on_the_card_launches_no_attention_kernel(cuda, tmp_path):
    """A train step of the tiny model on the card (dropout on, autograd)
    takes BERT's plain chain in every layer of every encoder call and
    launches no attention kernel: the kernel has no backward."""
    from opensearch_sparse_model_tuning_sample_torch.core import config
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
    from opensearch_sparse_model_tuning_sample_torch.train.trainer import Trainer

    ma, da, ta = config.parse_config({
        "arch": "tiny", "loss_types": ["infonce"], "use_in_batch_negatives": True,
        "learning_rate": 1e-3, "max_steps": 1, "warmup_steps": 0, "save_strategy": "no",
        "output_dir": str(tmp_path / "out"), "device": "cuda:0"})
    rng = np.random.default_rng(0)
    batch = {"q_input_ids": rng.integers(1000, 5000, (4, 8)),
             "q_attention_mask": np.ones((4, 8), np.int64),
             "d_input_ids": rng.integers(1000, 5000, (8, 16)),
             "d_attention_mask": np.ones((8, 16), np.int64)}
    model = tse.from_model_args(ma, seed=0, device=cuda)
    trainer = Trainer(model, ma, da, ta)
    before = _bert_attn_counts()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    launched, plain = (a - b for a, b in zip(_bert_attn_counts(), before))
    layers = model.cfg.num_hidden_layers
    assert launched == 0 and plain > 0 and plain % layers == 0, (launched, plain)


def test_bert_attention_over_the_kernels_grid_splits_its_launches(cuda):
    """A batch of more (doc, head) pairs than one launch of the kernel's
    grid takes (65 535: 5 462 docs at 12 heads) still takes the fused
    kernel, in launches of at most 65 535 // H docs: at [5 468, 32] two
    launches a layer and no plain chain. At the attention core the joined
    context equals BERT's plain chain on the live rows, the second launch's
    docs too (each (query, head) row within 2^-6 of its own scale, the mean
    within 2^-7, as the kernel's own test holds it). Through a
    DistilBERT-width model under inference_mode, the first and the last 50
    docs' pooled reps equal those docs encoded in a batch of their own (one
    launch a layer) within 2e-2 of each row's largest."""
    from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    B, L, H = 5468, 32, 12
    q, k, v, mask = _attn_inputs(B, L, H, 64, 65535, cuda)
    tracing.reset(list(_BERT_ATTN))
    got = tbert.fused_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert _bert_attn_counts() == [2, 0]
    ref = tbert.attention_chain(q, k, v, mask)
    live = mask.bool()
    for docs in (slice(0, B), slice(65535 // H, B)):
        g, r = got[docs].float()[live[docs]], ref[docs].float()[live[docs]]
        rel = (g - r).norm(dim=-1) / r.norm(dim=-1)
        assert float(rel.max()) <= 2 ** -6, float(rel.max())
        assert float(rel.mean()) <= 2 ** -7, float(rel.mean())
    del q, k, v, got, ref

    cfg = tbert.config_from_preset("distill", model_type="distilbert", use_token_type=False,
                                   type_vocab_size=1)
    model = tbert.from_state_dict(cfg, tbert.init_state_dict(cfg, seed=21), cuda)
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(1000, cfg.vocab_size, (B, L), generator=g).to(cuda)
    lens = torch.randint(L // 2, L + 1, (B,), generator=g)
    mask = (torch.arange(L)[None, :] < lens[:, None]).long().to(cuda)
    tracing.reset(list(_BERT_ATTN))
    with torch.inference_mode():
        reps = model.mlm_maxpool(model.encode_hidden(ids, mask), mask)
        torch.cuda.synchronize()
        assert _bert_attn_counts() == [2 * cfg.num_hidden_layers, 0]
        for docs in (slice(0, 50), slice(B - 50, B)):
            alone = model.mlm_maxpool(model.encode_hidden(ids[docs], mask[docs]), mask[docs])
            scale = alone.abs().amax(1, keepdim=True)
            assert bool(((reps[docs] - alone).abs() <= 2e-2 * scale).all())
    assert _bert_attn_counts() == [4 * cfg.num_hidden_layers, 0]


# --------------------------------------------------------------------------
# Moonlight (models/moonlight.py): the grouped expert GEMMs, routing without
# a host sync, causal attention at MLA's dims, the head at D 2 048


def _moe_inputs(R, D, I, E, seed, device, empty=(5, 17, 63)):
    """Rows sorted by expert with uneven groups: expert 0 takes a tenth of
    the rows, the experts in `empty` none, the rest share what is left;
    N(0, 1) rows and N(0, 0.02) weights, bf16."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    weights = torch.rand(E, generator=g) + 0.2
    weights[list(empty)] = 0.0
    weights[0] = weights.sum() / 9
    counts = torch.floor(weights / weights.sum() * R).long()
    counts[1] += R - int(counts.sum())
    offsets = torch.zeros(E + 1, dtype=torch.int32)
    offsets[1:] = torch.cumsum(counts, 0).to(torch.int32)
    x = torch.randn((R, D), generator=g).to(device, torch.bfloat16)
    gate, up = ((torch.randn((E, I, D), generator=g) * 0.02).to(device, torch.bfloat16)
                for _ in range(2))
    down = (torch.randn((E, D, I), generator=g) * 0.02).to(device, torch.bfloat16)
    return x, gate, up, down, offsets.to(device)


@pytest.mark.parametrize("R,D,I,E", [(24576, 2048, 1408, 64), (301, 64, 32, 8)],
                         ids=["moonlight", "tiny"])
def test_grouped_expert_gemms_match_a_per_expert_loop(cuda, R, D, I, E):
    """The gate-up (SiLU·mul fused, each row's token read in place through a
    shuffled token index) and down kernels against the plain per-expert loop
    (the same bf16 operands, exact products summed in fp32), with empty
    experts and ragged groups: each row within 2^-7 of its own
    norm (the kernels sum in another order and round once to bf16), one
    launch each."""
    from opensearch_sparse_model_tuning_sample_torch.ops import moe
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    x, gate, up, down, offsets = _moe_inputs(R, D, I, E, R + D, cuda,
                                             empty=(5, 17, 63) if E == 64 else (3,))
    names = ["moe.launches.moe_gate_up_kernel", "moe.launches.moe_down_kernel"]
    tracing.reset(names)
    token = torch.randperm(R, generator=torch.Generator().manual_seed(R)).to(cuda)
    h = moe.expert_gate_up(x, token, gate, up, offsets)
    y = moe.expert_down(h, down, offsets)
    torch.cuda.synchronize()
    assert [tracing.counters()[n] for n in names] == [1, 1]
    h_ref = moe.expert_gate_up_reference(x.index_select(0, token), gate, up, offsets)
    y_ref = moe.expert_down_reference(h, down, offsets)
    for got, ref in ((h, h_ref), (y, y_ref)):
        rel = (got.float() - ref.float()).norm(dim=-1) / ref.float().norm(dim=-1).clamp_min(1e-6)
        assert float(rel.max()) <= 2 ** -7, float(rel.max())


@pytest.mark.parametrize("T,D,E,k", [(13824, 2048, 64, 6), (301, 64, 8, 2)],
                         ids=["moonlight", "tiny"])
def test_combine_matches_the_slot_loop(cuda, T, D, E, k):
    """The combine kernel against the plain slot loop on the same inputs:
    rows from a router over random scores (some experts empty), each
    token's k rows weighted in slot order and the shared output added into
    an fp32 stream, each row within 1e-5 of its own norm; the same bits on
    a second launch; one launch."""
    from opensearch_sparse_model_tuning_sample_torch.ops import moe
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    g = torch.Generator(device="cpu").manual_seed(T + D)
    bias = torch.zeros(E)
    bias[: E // 8] = -10.0  # these experts take no row
    chosen, w = moe.route(torch.randn((T, D), generator=g).to(cuda),
                          (torch.randn((E, D), generator=g) * 0.02).to(cuda), bias.to(cuda), k,
                          2.446)
    _, _, pos = moe.permute(chosen, E)
    y = torch.randn((T * k, D), generator=g).to(cuda, torch.bfloat16)
    shared = torch.randn((T, D), generator=g).to(cuda, torch.bfloat16)
    x = torch.randn((T, D), generator=g).to(cuda)
    tracing.reset(["moe.launches.moe_combine_kernel"])
    got = moe.combine(x.clone(), y, shared, pos, w)
    again = moe.combine(x.clone(), y, shared, pos, w)
    torch.cuda.synchronize()
    assert tracing.counters()["moe.launches.moe_combine_kernel"] == 2
    ref = moe.combine_reference(x.clone(), y, shared, pos, w)
    rel = (got - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-6)
    assert float(rel.max()) <= 1e-5, float(rel.max())
    assert torch.equal(got, again)


def test_routing_and_experts_make_no_host_sync(cuda):
    """A whole Moonlight forward at test widths (router, top-k, the sort and
    offsets, the grouped GEMMs, the combine, causal attention, the head)
    runs under the sync debug mode's "error": nothing in a layer waits for
    the card. The combine is the same bit for bit on a second run."""
    from opensearch_sparse_model_tuning_sample_torch.models import moonlight

    cfg = moonlight.config_from_preset("moonlight-tiny")
    model = moonlight.from_state_dict(cfg, moonlight.init_state_dict(cfg, 4, cuda), cuda)
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(5, 512, (6, 128), generator=g).to(cuda)
    mask = (torch.arange(128)[None, :] < torch.tensor([128, 100, 64, 33, 7, 1])[:, None]).int()
    mask = mask.to(cuda)
    with torch.no_grad():
        first = model.mlm_maxpool(model.encode_hidden(ids, mask), mask)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            second = model.mlm_maxpool(model.encode_hidden(ids, mask), mask)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(first, second)


@pytest.mark.parametrize("B,L,hqk,hv", [(64, 512, 192, 128), (5, 1000, 192, 128),
                                        (7, 130, 32, 16)], ids=["cell", "odd1000", "tiny"])
def test_causal_attention_matches_the_plain_masked_path(cuda, B, L, hqk, hv):
    """The causal kernel at MLA's dims (q·k 192, v 128) against the plain
    version on the live query rows, each (query, head) row held to its own
    scale as in the global and windowed kinds (worst within 2^-6, mean
    within 2^-7); it counts `computed_pairs` (the key tiles up to each
    query tile's diagonal, under 0.6 of L² at L 512)."""
    from opensearch_sparse_model_tuning_sample_torch.ops import attention as at
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    H = 16 if hqk == 192 else 4
    g = torch.Generator(device="cpu").manual_seed(B + L)
    q, k = (torch.randn((B, L, H, hqk), generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    kv = torch.randn((B, L, H, hqk + hv), generator=g).to(cuda, torch.bfloat16)
    v = kv[..., hqk:]  # a strided view, as the model's
    lens = torch.randint(1, L + 1, (B,), generator=g)
    lens[0] = L
    mask = (torch.arange(L)[None, :] < lens[:, None]).to(torch.int32).to(cuda)
    names = ["encoder.attn.pairs.causal", "attn.launches.attention_causal_kernel"]
    tracing.reset(names)
    got = at.attention(q, k, v, mask, causal=True)
    torch.cuda.synchronize()
    c = tracing.counters()
    assert c[names[0]] == at.computed_pairs(B, L, 0, causal=True) and c[names[1]] == 1
    assert at.computed_pairs(1, 512, 0, causal=True) < 0.6 * 512 * 512
    ref = at.attention_reference(q, k, v, mask, causal=True)
    live = mask.bool()
    gl, rl = got.float()[live], ref.float()[live]
    rel = (gl - rl).norm(dim=-1) / rl.norm(dim=-1)
    assert bool(torch.isfinite(got.float()).all())
    assert float(rel.max()) <= 2 ** -6, float(rel.max())
    assert float(rel.mean()) <= 2 ** -7, float(rel.mean())


def test_head_kernel_at_moonlight_width_matches_plain(cuda):
    """The ingest head at [64, 512, 2 048, 163 840] (past the widest
    resident tile: the streamed w tile), lengths of the cell's law, against
    the plain version on 2 048 of the vocab's columns spread over every
    tile's position and the last tile; the same bound as `_check`."""
    rng = np.random.default_rng(7)
    lens = np.clip(rng.lognormal(np.log(178), 0.6, 64), 20, 512).astype(int)
    mask = (np.arange(512)[None, :] < lens[:, None]).astype(np.int32)
    h, mask, w, bias = _inputs(64, 512, 2048, 163840, 11, cuda, mask=mask)
    before = _launches(maxpool_head)
    got = maxpool_head(h, mask, w, bias)
    torch.cuda.synchronize()
    assert _launches(maxpool_head) == before + 1
    cols = torch.cat([torch.arange(0, 163840, 97), torch.arange(163840 - 128, 163840)])
    cols = cols.unique()[:2048].to(cuda)
    ref = maxpool_head_reference(h, mask, w[cols].contiguous(), bias[cols].contiguous())
    err = (got[:, cols] - ref).abs()
    assert bool((err <= 1e-3 * ref.abs().clamp_min(1.0)).all()), float(err.max())


def test_tiny_moonlight_on_the_card_matches_the_cpu(cuda):
    """encode_doc of Moonlight at test widths (a dense layer, expert layers
    of 8 experts, 2 a token, causal MLA at q·k 32, v 16) on the card (the
    attention, expert and head kernels) against the CPU (their plain
    versions), bf16 compute on both: the reps within 2e-2 of each row's
    largest (bf16 products summed in another order). The weights are drawn
    once on the CPU (a card's generator draws other values for a seed)."""
    from opensearch_sparse_model_tuning_sample_torch.models import moonlight
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
    from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import load_tokenizer

    cfg = moonlight.config_from_preset("moonlight-tiny")
    sd = moonlight.init_state_dict(cfg, 3)
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(5, 512, (4, 200), generator=g)
    mask = (torch.arange(200)[None, :] < torch.tensor([200, 150, 64, 7])[:, None]).int()
    reps = []
    for dev in (cuda, torch.device("cpu")):
        model = tse.SparseEncoderModel(cfg, moonlight.from_state_dict(cfg, sd, dev),
                                       torch.ones(cfg.vocab_size), load_tokenizer(None))
        with torch.no_grad():
            reps.append(tse.encode_doc(model, ids.to(dev), mask.to(dev)).cpu())
    scale = reps[1].abs().amax(1, keepdim=True)
    assert bool(((reps[0] - reps[1]).abs() <= 2e-2 * scale).all())


# ---- BERT's encoder stack replayed as CUDA graphs (models/bert.py) --------

_GRAPH = ("encoder.graph.captures", "encoder.graph.replays", "encoder.graph.eager")
_DISTIL = {}


def _distil_bert(cuda):
    """A DistilBERT-width BertForMaskedLM on the card (random weights), made
    once for the tests below, and its config."""
    from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert

    if "model" not in _DISTIL:
        cfg = tbert.config_from_preset("distill", model_type="distilbert", use_token_type=False,
                                       type_vocab_size=1)
        _DISTIL["model"] = tbert.from_state_dict(cfg, tbert.init_state_dict(cfg, seed=24), cuda)
    return _DISTIL["model"]


def _full_batch(L, cuda, seed=None, B=50):
    """ids [B, L] and an int32 mask of a sorted chunk's full batch at L: live
    lengths in (L - 64, L], one row full."""
    g = torch.Generator().manual_seed(L if seed is None else seed)
    ids = torch.randint(1000, 30522, (B, L), generator=g)
    lens = torch.randint(max(L - 63, 1), L + 1, (B,), generator=g)
    lens[0] = L
    mask = (torch.arange(L)[None, :] < lens[:, None]).to(torch.int32)
    return ids.to(cuda), mask.to(cuda)


def _graph_counts():
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    c = tracing.counters()
    return {n: c.get(n, 0) for n in _GRAPH}


@pytest.mark.parametrize("L", list(range(64, 513, 64)))
def test_graph_runner_equals_the_eager_stack_bit_for_bit(cuda, L):
    """At DistilBERT's widths and a sorted chunk's full batch [50, L], the
    runner's hidden states (a capture, then replays of other batches of the
    shape) equal the eager stack's bit for bit, and `graph_maxpool` equals
    the eager head over the eager stack."""
    model = _distil_bert(cuda)
    for seed in (L, L + 1, L + 2):
        ids, mask = _full_batch(L, cuda, seed)
        with torch.inference_mode():
            eager = model.encode_hidden(ids, mask)
            got = model.graph_runner(model, ids, mask).clone()
            assert torch.equal(got, eager)
            assert torch.equal(model.graph_maxpool(ids, mask), model.mlm_maxpool(eager, mask))
    assert (tuple(ids.shape), ids.dtype, mask.dtype) in model.graph_runner.graphs


def test_graph_replays_count_as_eager_forwards(cuda):
    """n replays raise the counters n eager forwards raise (the attention
    kernel's launches and pairs, no plain chain); the capture's own warm-up
    counts nothing; captures and replays are counted."""
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    model = _distil_bert(cuda)
    names = ("attn.launches.attention_global_kernel", "encoder.attn.pairs.global",
             "encoder.attn.plain_chain")
    ids, mask = _full_batch(320, cuda, seed=5, B=37)
    n = 4
    tracing.reset(names + _GRAPH)
    with torch.inference_mode():
        for _ in range(n):
            model.encode_hidden(ids, mask)
    eager = {k: tracing.counters().get(k, 0) for k in names}
    assert eager[names[0]] == n * model.cfg.num_hidden_layers and eager[names[2]] == 0
    tracing.reset(names + _GRAPH)
    for _ in range(n):
        model.graph_maxpool(ids, mask)
    torch.cuda.synchronize()
    assert {k: tracing.counters().get(k, 0) for k in names} == eager
    assert _graph_counts() == {"encoder.graph.captures": 1, "encoder.graph.replays": n,
                               "encoder.graph.eager": 0}


def test_graph_replay_sees_a_weight_changed_in_place(cuda):
    """A weight changed in place after the capture (as a trainer's step
    changes it) is read by the next replay: the replay equals the eager
    stack over the changed weights, and nothing is captured again."""
    from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    cfg = tbert.config_from_preset("mini")
    model = tbert.from_state_dict(cfg, tbert.init_state_dict(cfg, seed=2), cuda)
    ids, mask = _full_batch(128, cuda, seed=3, B=10)
    with torch.inference_mode():
        before = model.graph_runner(model, ids, mask).clone()
        tracing.reset(_GRAPH)
        with torch.no_grad():
            model.layers[1].ffn.intermediate.weight.mul_(1.5)
            model.embeddings.position_embeddings.add_(0.01)
        got = model.graph_runner(model, ids, mask).clone()
        eager = model.encode_hidden(ids, mask)
    assert torch.equal(got, eager) and not torch.equal(got, before)
    assert _graph_counts()["encoder.graph.captures"] == 0


@pytest.mark.parametrize("how", ["parameter", "data", "to"])
def test_replaced_parameters_never_replay_stale_pointers(cuda, how):
    """Weights replaced by other tensors after a capture (a new Parameter
    in a module, a tensor swapped in as `.data`, `module.to` of another
    dtype) drop the graphs: the next call captures again and
    equals the eager stack over the new weights."""
    from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    cfg = tbert.config_from_preset("mini")
    model = tbert.from_state_dict(cfg, tbert.init_state_dict(cfg, seed=4), cuda)
    ids, mask = _full_batch(192, cuda, seed=6, B=10)
    dense = model.layers[0].attention.output
    with torch.inference_mode():
        model.graph_runner(model, ids, mask)
    with torch.no_grad():
        if how == "parameter":
            dense.weight = torch.nn.Parameter(dense.weight.detach() * 2)
        elif how == "data":
            dense.weight.data = dense.weight.detach() * 2
        else:
            model.to(torch.float64)
            dense.weight.mul_(2)
    tracing.reset(_GRAPH)
    with torch.inference_mode():
        got = model.graph_runner(model, ids, mask).clone()
        eager = model.encode_hidden(ids, mask)
    assert torch.equal(got, eager)
    assert _graph_counts()["encoder.graph.captures"] == 1
    assert len(model.graph_runner.graphs) == 1


def test_short_first_batch_runs_eagerly(cuda):
    """A chunk of 57 docs in batches of 10 on the card: the short first batch
    (7 rows) runs the stack eagerly, the five full ones replay graphs."""
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    model = tse.build_model(arch="mini", idf_path="assets/idf.npz", seed=0, device=cuda)
    enc = tse.BatchEncoder(model, max_length=512)
    chunk = _mixed_chunks(31, sizes=(57,))[0]
    tracing.reset(_GRAPH)
    enc.resolve_chunk_sparse(*enc.encode_chunk_sparse_async(chunk, l_max=64, rows=10))
    c = _graph_counts()
    assert c["encoder.graph.eager"] == 1 and c["encoder.graph.replays"] == 5, c
    assert 1 <= c["encoder.graph.captures"] <= 5


def test_pipelined_chunks_through_graphs_equal_the_eager_path(cuda, monkeypatch):
    """Chunks queued in ingest's order (each resolved after the next is
    queued), their full batches replaying graphs, give the rows and the
    count the eager path gives, bit for bit."""
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    model = tse.build_model(arch="mini", idf_path="assets/idf.npz", seed=0, device=cuda)
    chunks = _mixed_chunks(37)

    def run():
        enc = tse.BatchEncoder(model, max_length=512)
        rows, prev = [], None
        for c in chunks:
            handle = enc.encode_chunk_sparse_async(c, l_max=64, rows=10)
            if prev is not None:
                rows.append(enc.resolve_chunk_sparse(*prev))
            prev = handle
        rows.append(enc.resolve_chunk_sparse(*prev))
        return rows, enc.count_tensor

    tracing.reset(_GRAPH)
    graphed, graphed_count = run()
    assert _graph_counts()["encoder.graph.replays"] == sum(len(c) // 10 for c in chunks)
    monkeypatch.setattr(tse, "takes_graph", lambda device, batch_rows, rows: False)
    eager, eager_count = run()
    for (gi, gw), (ei, ew) in zip(graphed, eager):
        np.testing.assert_array_equal(gi, ei)
        np.testing.assert_array_equal(gw, ew)
    np.testing.assert_array_equal(graphed_count, eager_count)


@pytest.mark.parametrize("arch", ["modernbert-tiny", "moonlight-tiny"])
def test_other_backbones_capture_nothing(cuda, arch, tmp_path):
    """ModernBERT and Moonlight have no graph runner: their ingest batches
    all run eagerly on the card and nothing is captured."""
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    words = "alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu".split()
    (tmp_path / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                                                  + words) + "\n")
    model = tse.build_model(arch=arch, tokenizer_name=str(tmp_path), seed=3, device=cuda)
    rng = np.random.default_rng(3)
    docs = [" ".join(rng.choice(words, int(n))) for n in rng.integers(3, 150, size=24)]
    enc = tse.BatchEncoder(model, max_length=256)
    tracing.reset(_GRAPH)
    enc.resolve_chunk_sparse(*enc.encode_chunk_sparse_async(docs, l_max=16, rows=8))
    assert _graph_counts() == {"encoder.graph.captures": 0, "encoder.graph.replays": 0,
                               "encoder.graph.eager": 3}


def test_graph_kernels_show_in_a_profile(cuda):
    """A capture made while a profiler records, and its replays, leave the
    stack's kernels (the fused attention among them) in the profile's
    device events."""
    from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert

    cfg = tbert.config_from_preset("mini")
    model = tbert.from_state_dict(cfg, tbert.init_state_dict(cfg, seed=8), cuda)
    ids, mask = _full_batch(256, cuda, seed=9, B=10)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            model.graph_maxpool(ids, mask)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    launched = sum("attention_global_kernel" in n for n in names)
    # the replays' 3 x 4 layers (the warm-up's 4 and the capture's none besides)
    assert launched >= 3 * cfg.num_hidden_layers, launched


def test_graph_maxpool_from_threads_equals_eager(cuda):
    """Twelve threads (more than the host's cores) replay one shape's graph
    at once, each with its own batch, the interpreter switching threads
    every microsecond: each call's pooled rep equals the eager stack and
    head over its own batch, so no thread's static inputs or outputs are
    overwritten by another's before its head has read them."""
    import sys
    import threading

    from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert

    cfg = tbert.config_from_preset("mini")
    model = tbert.from_state_dict(cfg, tbert.init_state_dict(cfg, seed=12), cuda)
    batches = [_full_batch(192, cuda, seed=100 + t, B=10) for t in range(12)]
    with torch.inference_mode():
        want = [model.mlm_maxpool(model.encode_hidden(i, m), m) for i, m in batches]
    got = [[] for _ in batches]

    def work(t):
        for _ in range(5):
            got[t].append(model.graph_maxpool(*batches[t]))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(len(batches))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    torch.cuda.synchronize()
    for t, reps in enumerate(got):
        assert len(reps) == 5 and all(torch.equal(r, want[t]) for r in reps), t


# --------------------------------------------------------------------------
# Kimi Linear (models/kimi_linear.py): KDA's chunked kernels, the held-expert
# share of the grouped GEMMs, causal MLA at 32 heads and 32k positions, the
# head at D 2 304


def _kda_inputs(B, L, H, d, seed, device, A=4.0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn((B, L, H, d), generator=g), dim=-1)
    k = torch.nn.functional.normalize(torch.randn((B, L, H, d), generator=g), dim=-1)
    v = torch.randn((B, L, H, d), generator=g)
    decay = -A * torch.nn.functional.softplus(torch.randn((B, L, H, d), generator=g) - 3.0)
    beta = torch.sigmoid(torch.randn((B, L, H), generator=g))
    return (q.to(device, torch.bfloat16), k.to(device, torch.bfloat16),
            v.to(device, torch.bfloat16), decay.to(device), beta.to(device))


@pytest.mark.parametrize("B,L,H,d,A", [(2, 64, 32, 128, 4.0), (1, 4096, 32, 128, 4.0),
                                       (1, 32768, 32, 128, 4.0), (2, 333, 32, 128, 16.0),
                                       (3, 150, 2, 16, 4.0)],
                         ids=["L64", "L4096", "L32768", "odd_strong", "tiny"])
def test_kda_kernels_match_the_plain_chunked_path(cuda, B, L, H, d, A):
    """KDA's two kernels at the published widths (32 heads, dk = dv = 128)
    against the plain chunked path on the same bf16 inputs in fp32: each
    (position, head) row's gap within 1/32 of the row's largest value and
    the mean within 1/512 (the kernels round the chunk's operands and the
    state to bf16 for their products); one launch of each; finite."""
    from opensearch_sparse_model_tuning_sample_torch.ops import kda as kda_op
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    q, k, v, decay, beta = _kda_inputs(B, L, H, d, L + H, cuda, A)
    names = ["kda.launches.kda_intra_kernel", "kda.launches.kda_state_kernel"]
    tracing.reset(names)
    got = kda_op.kda(q, k, v, decay, beta, d ** -0.5)
    torch.cuda.synchronize()
    assert [tracing.counters()[n] for n in names] == [1, 1]
    ref = kda_op.kda_chunked_reference(q, k, v, decay, beta, d ** -0.5)
    err = (got - ref).abs() / ref.abs().amax(-1, keepdim=True).clamp_min(1e-6)
    assert bool(torch.isfinite(got).all())
    assert float(err.max()) <= 1 / 32, float(err.max())
    assert float(err.mean()) <= 1 / 512, float(err.mean())


@pytest.mark.parametrize("which", ["conv_norm", "conv", "decay", "gated_norm"])
def test_kda_elementwise_kernels_match_plain_at_published_widths(cuda, which):
    """KDA's elementwise kernels at 32 heads of 128 over [2, 4 096] (the
    short conv with SiLU, with the L2 norm for q and k and without for v;
    the decay gate; the gated norm) against their plain torch versions on
    inputs of the model's scales: each (position, head) row within 2^-7 of
    its largest value where both round to bf16, 1e-4 where both stay in
    fp32; one launch."""
    import math

    from opensearch_sparse_model_tuning_sample_torch.ops import kda as kda_op
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    B, L, H, d, K = 2, 4096, 32, 128, 4
    C = H * d
    g = torch.Generator(device="cpu").manual_seed(41)
    if which.startswith("conv"):
        x = torch.randn((B, L, C), generator=g).to(cuda, torch.bfloat16)
        w = (torch.rand((C, K), generator=g) - 0.5).to(cuda)
        norm = which == "conv_norm"
        args, kernel, plain, name, tol = ((x, w, d, norm), kda_op.conv_silu,
                                          kda_op.conv_silu_reference, "kda_conv_kernel", 2 ** -7)
    elif which == "decay":
        f = (torch.randn((B, L, C), generator=g) * 0.2).to(cuda)
        a_log = torch.log(1.0 + 15.0 * torch.rand(H, generator=g)).to(cuda)
        dt = torch.exp(math.log(1e-3) + torch.rand(C, generator=g) * math.log(100.0))
        args, kernel, plain, name, tol = ((f, a_log, (dt + torch.log(-torch.expm1(-dt))).to(cuda),
                                           d), kda_op.decay, kda_op.decay_reference,
                                          "kda_gate_kernel", 1e-4)
    else:
        o = torch.randn((B, L, H, d), generator=g).to(cuda)
        gate = (torch.randn((B, L, C), generator=g) * 0.2).to(cuda)
        w = (1.0 + 0.1 * torch.randn(d, generator=g)).to(cuda)
        args, kernel, plain, name, tol = ((o, w, gate, 1e-5, torch.bfloat16), kda_op.gated_norm,
                                          kda_op.gated_norm_reference, "kda_gated_norm_kernel",
                                          2 ** -7)
    tracing.reset(["kda.launches." + name])
    got = kernel(*args).float()
    torch.cuda.synchronize()
    assert tracing.counters()["kda.launches." + name] == 1
    ref = plain(*args).float()
    assert got.shape == ref.shape == (B, L, H, d)
    err = (got - ref).abs() / ref.abs().amax(-1, keepdim=True).clamp_min(1e-6)
    assert bool(torch.isfinite(got).all())
    assert float(err.max()) <= tol, float(err.max())


def test_held_expert_share_matches_the_plain_layer(cuda):
    """Kimi Linear's expert layer at its widths (D 2 304, I 1 024), 128 of 256
    experts held, 8 a token: the gate-up kernel, the down kernel and the
    combine (rows of absent experts never computed, left out) against the
    per-expert loop over the held rows and the slot loop, within 2^-7 of
    each row's norm; the launches; the held rows counted on the card."""
    from opensearch_sparse_model_tuning_sample_torch.ops import moe
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    T, D, I, E, held, k = 3000, 2304, 1024, 256, 128, 8
    g = torch.Generator(device="cpu").manual_seed(9)
    u = torch.randn((T, D), generator=g).to(cuda, torch.bfloat16)
    chosen = torch.stack([torch.randperm(E, generator=g)[:k] for _ in range(T)]).to(cuda)
    w = torch.rand((T, k), generator=g).to(cuda)
    gate, up = ((torch.randn((held, I, D), generator=g) * 0.02).to(cuda, torch.bfloat16)
                for _ in range(2))
    down = (torch.randn((held, D, I), generator=g) * 0.02).to(cuda, torch.bfloat16)
    shared = torch.randn((T, D), generator=g).to(cuda, torch.bfloat16)
    x = torch.randn((T, D), generator=g).to(cuda)
    names = ["moe.launches.moe_gate_up_kernel", "moe.launches.moe_down_kernel",
             "moe.launches.moe_combine_kernel"]
    tracing.reset(names)
    got = moe.experts(u, x.clone(), chosen, w, gate, up, down, shared, 0)
    torch.cuda.synchronize()
    assert [tracing.counters().get(n, 0) for n in names] == [1, 1, 1]
    token, offsets, pos = moe.permute(chosen, held, 0)
    assert int(offsets[-1]) == int((chosen < held).sum())
    h = moe.expert_gate_up_reference(u.index_select(0, token), gate, up, offsets)
    y = moe.expert_down_reference(h, down, offsets)
    ref = moe.combine_reference(x.clone(), y, shared, pos, w)
    rel = (got - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-6)
    assert float(rel.max()) <= 2 ** -7, float(rel.max())


def test_causal_attention_at_32_heads_and_32k_positions(cuda):
    """The causal kernel at Kimi Linear's MLA (32 heads, q·k 192, v 128) over
    one doc of 32 768 positions, against the plain path on the query rows of
    four spread tiles, held as in the other causal test."""
    from opensearch_sparse_model_tuning_sample_torch.ops import attention as at

    B, L, H = 1, 32768, 32
    g = torch.Generator(device="cpu").manual_seed(31)
    q, k = (torch.randn((B, L, H, 192), generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    v = torch.randn((B, L, H, 128), generator=g).to(cuda, torch.bfloat16)
    mask = torch.ones((B, L), dtype=torch.int32, device=cuda)
    mask[:, L - 100:] = 0
    got = at.attention(q, k, v, mask, causal=True)
    torch.cuda.synchronize()
    rows = torch.cat([torch.arange(s, s + 64) for s in (0, 8192, 20480, L - 164)]).to(cuda)
    qh, kh, vh = (t[0].transpose(0, 1).float() for t in (q, k, v))
    pos = torch.arange(L, device=cuda)
    for h in range(0, H, 8):
        logits = qh[h:h + 8, rows] @ kh[h:h + 8].transpose(-1, -2) / 192 ** 0.5
        ok = (pos[None, :] <= rows[:, None]) & mask[0].bool()[None, :]
        p = torch.softmax(logits.masked_fill(~ok, float("-inf")), -1)
        ref = (p.to(torch.bfloat16).float() @ vh[h:h + 8]).transpose(0, 1)
        gl = got[0, rows, h:h + 8].float()
        rel = (gl - ref).norm(dim=-1) / ref.norm(dim=-1)
        assert float(rel.max()) <= 2 ** -6, float(rel.max())


def test_head_kernel_at_kimi_linear_width_matches_plain(cuda):
    """The ingest head at [2, 30 912, 2 304, 163 840] (the cell's largest
    batch: docs of 30 853 and 20 928 tokens; the streamed w tile) against
    the plain version on 1 024 of the vocab's columns."""
    lens = np.array([30853, 20928])
    L = 30912
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    h, mask, w, bias = _inputs(2, L, 2304, 163840, 12, cuda, mask=mask)
    got = maxpool_head(h, mask, w, bias)
    torch.cuda.synchronize()
    cols = torch.cat([torch.arange(0, 163840, 163), torch.arange(163840 - 64, 163840)])
    cols = cols.unique()[:1024].to(cuda)
    ref = maxpool_head_reference(h, mask, w[cols].contiguous(), bias[cols].contiguous())
    err = (got[:, cols] - ref).abs()
    assert bool((err <= 1e-3 * ref.abs().clamp_min(1.0)).all()), float(err.max())


def test_tiny_kimi_linear_on_the_card_matches_the_cpu(cuda):
    """encode_doc of Kimi Linear at test widths (KDA at dk = dv = 16, causal
    MLA at q·k 32, v 16, experts with a held share) on the card (the KDA,
    attention, expert and head kernels) against the CPU (their plain
    versions), bf16 compute on both: the reps within 3e-2 of each row's
    largest. The weights are drawn once on the CPU. No forward waits for the
    card (the sync debug mode's "error")."""
    from opensearch_sparse_model_tuning_sample_torch.models import kimi_linear as kl
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
    from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import load_tokenizer

    cfg = kl.config_from_preset("kimi-linear-tiny", experts_held=8, experts_first=4)
    sd = kl.init_state_dict(cfg, 3)
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(5, 512, (4, 200), generator=g)
    mask = (torch.arange(200)[None, :] < torch.tensor([200, 150, 64, 7])[:, None]).int()
    reps = []
    for dev in (cuda, torch.device("cpu")):
        model = tse.SparseEncoderModel(cfg, kl.from_state_dict(cfg, sd, dev),
                                       torch.ones(cfg.vocab_size), load_tokenizer(None))
        i, m = ids.to(dev), mask.to(dev)
        with torch.no_grad():
            if dev.type == "cuda":
                tse.encode_doc(model, i, m)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                rep = tse.encode_doc(model, i, m)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        reps.append(rep.cpu())
    scale = reps[1].abs().amax(1, keepdim=True)
    assert bool(((reps[0] - reps[1]).abs() <= 3e-2 * scale).all())

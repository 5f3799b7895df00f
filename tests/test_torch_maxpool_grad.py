"""The max-pool head's gradient. On the CPU the port's `MaxPoolHead`
Function runs the kernels' plain versions: the argmax forward and the dense
scatter + matmul backward. Held here against

  * `jax.grad` through the JAX package's production head `bert.mlm_maxpool`
    (fp32 weights, the same numpy inputs): the gradients of the hidden
    states, the decoder (tied word embeddings or an untied decoder) and the
    bias, 1e-4 relative (fp32 sums in another order) with an absolute floor
    of 1e-5 of the tensor's largest entry;
  * torch autograd of `maxpool_head_reference` in float64, 1e-10.

Inputs have holey masks and an all-masked row, and L not a multiple of 64.
Ties: JAX splits a tied maximum evenly and the argmax gives it to one
position; random fp32 inputs tie only at 0, where a masked position wins and
both give no gradient (its mask is 0). The kernels themselves are held
against these plain versions on the card (tests/test_torch_gpu.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_sparse_model_tuning_sample_tpu.models import bert as jbert
from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert
from opensearch_sparse_model_tuning_sample_torch.models.convert import params_from_jax
from opensearch_sparse_model_tuning_sample_torch.ops import maxpool as mp
from test_torch_gpu import _calls

torch.set_num_threads(2)


def _holey_mask(B, L, rng):
    """Left padding, interior holes, a masked stretch in mid-row, right
    padding, an all-masked row and a full row."""
    mask = np.ones((B, L), np.int32)
    mask[0, : L // 3] = 0
    mask[1, rng.choice(L, size=max(1, L // 4), replace=False)] = 0
    mask[2, L // 3: 2 * L // 3] = 0
    mask[3, L // 2:] = 0
    mask[4] = 0
    return mask


def _port_model(jcfg, params):
    tcfg = tbert.BertConfig(**{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tbert.BertConfig)
        if f.name not in ("param_dtype", "compute_dtype")
    }, compute_dtype=torch.float32)
    return tbert.from_state_dict(
        tcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg),
        torch.device("cpu"))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("untied", [False, True])
@pytest.mark.parametrize("L", [24, 70])
def test_function_gradients_match_jax_grad(untied, L):
    jcfg = jbert.config_from_preset("tiny", vocab_size=1000, compute_dtype=jnp.float32)
    params = jbert.init(jax.random.PRNGKey(7), jcfg)
    rng = np.random.default_rng(L + untied)
    if untied:
        params["mlm_head"]["decoder"] = jnp.asarray(
            rng.normal(size=(jcfg.padded_vocab_size, jcfg.hidden_size)).astype(np.float32) * 0.02)
    B, D = 6, jcfg.hidden_size
    hidden = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = _holey_mask(B, L, rng)
    G = rng.normal(size=(B, jcfg.padded_vocab_size)).astype(np.float32)
    # the padded vocab columns get no gradient, as in the encoder (which
    # drops them): tied, their zero rows and zero bias tie at every position
    G[:, jcfg.vocab_size:] = 0.0

    def jloss(p, x):
        return jnp.sum(jbert.mlm_maxpool(p, jcfg, x, jnp.asarray(mask), chunk=16) * G)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(hidden))
    dec_key = "decoder" if untied else None

    model = _port_model(jcfg, params)
    x = torch.from_numpy(hidden).requires_grad_()
    pooled = model.mlm_maxpool(x, torch.from_numpy(mask))
    assert pooled.grad_fn is not None and "MaxPoolHead" in type(pooled.grad_fn).__name__
    (pooled * torch.from_numpy(G)).sum().backward()

    _close(x.grad.numpy(), np.asarray(jg_x), "d hidden")
    dec = model.mlm_head.decoder if untied else model.embeddings.word_embeddings
    want_dec = jg_p["mlm_head"][dec_key] if untied else jg_p["embeddings"]["word_embeddings"]
    _close(dec.grad.numpy(), np.asarray(want_dec), "d decoder")
    _close(model.mlm_head.bias.grad.numpy(), np.asarray(jg_p["mlm_head"]["bias"]), "d bias")
    _close(model.mlm_head.transform.weight.grad.numpy(),
           np.asarray(jg_p["mlm_head"]["transform"]["kernel"]).T, "d head transform")
    # the all-masked row pools to exactly 0 and sends nothing back
    assert (pooled[4] == 0).all() and (x.grad[4] == 0).all()


@pytest.mark.parametrize("B,L,D,V", [(6, 70, 16, 130), (6, 130, 8, 64)])
def test_plain_backward_is_autograd_of_the_plain_forward(B, L, D, V):
    """float64: the argmax forward's values are maxpool_head_reference's, and
    the scatter + matmul backward is its autograd."""
    rng = np.random.default_rng(B * L)
    h = torch.from_numpy(rng.normal(size=(B, L, D))).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(V, D))).requires_grad_()
    bias = torch.from_numpy(rng.normal(size=(V,))).requires_grad_()
    mask = torch.from_numpy(_holey_mask(B, L, rng))
    g = torch.from_numpy(rng.normal(size=(B, V)))
    ref = mp.maxpool_head_reference(h, mask, w, bias)
    (ref * g).sum().backward()
    with torch.no_grad():
        pooled, idx = mp.maxpool_head_argmax_reference(h, mask, w, bias)
        dw, dbias = mp.maxpool_head_bwd_w_reference(g, idx, mask, h)
        dh = mp.maxpool_head_bwd_h_reference(g, idx, mask, w)
        # the logit at the argmax is the pooled value
        logit = torch.einsum("bvd,vd->bv", h[torch.arange(B)[:, None], idx.long()], w)
        at = (logit + bias) * mask.gather(1, idx.long())
    assert idx.dtype == torch.int32 and bool(((idx >= 0) & (idx < L)).all())
    torch.testing.assert_close(pooled, ref.detach(), rtol=0, atol=0)
    torch.testing.assert_close(at, pooled, rtol=1e-12, atol=1e-12)
    for got, want in ((dh, h.grad), (dw, w.grad), (dbias, bias.grad)):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def test_function_keeps_the_input_dtypes():
    """bf16 h and w (the cast copies of fp32 parameters) get bf16 gradients,
    which flow on through the casts; the bias's stays fp32."""
    rng = np.random.default_rng(0)
    wf = torch.from_numpy(rng.normal(size=(40, 16)).astype(np.float32)).requires_grad_()
    hf = torch.from_numpy(rng.normal(size=(3, 9, 16)).astype(np.float32)).requires_grad_()
    bias = torch.zeros(40, requires_grad=True)
    mask = torch.ones(3, 9, dtype=torch.int32)
    h, w = hf.to(torch.bfloat16), wf.to(torch.bfloat16)
    h.retain_grad()
    w.retain_grad()
    mp.maxpool_head_train(h, mask, w, bias).sum().backward()
    assert h.grad.dtype == w.grad.dtype == torch.bfloat16
    assert hf.grad.dtype == wf.grad.dtype == bias.grad.dtype == torch.float32
    assert float(bias.grad.sum()) == pytest.approx(3 * 40)  # each (b, v) once


@pytest.mark.parametrize("which", ["maxpool_head", "maxpool_head_argmax", "bwd_w", "bwd_h"])
def test_raw_wrappers_raise_on_inputs_that_require_grad(which):
    """Outside the Function a kernel would return a tensor with no gradient;
    the raw wrappers refuse, and take the same inputs under no_grad."""
    B, L, D, V = 2, 5, 8, 12
    h = torch.randn(B, L, D, requires_grad=True)
    w = torch.randn(V, D)
    bias = torch.zeros(V)
    mask = torch.ones(B, L, dtype=torch.int32)
    g = torch.randn(B, V, requires_grad=True)
    idx = torch.zeros(B, V, dtype=torch.int32)
    call = {
        "maxpool_head": lambda: mp.maxpool_head(h, mask, w, bias),
        "maxpool_head_argmax": lambda: mp.maxpool_head_argmax(h, mask, w, bias),
        "bwd_w": lambda: mp.maxpool_head_bwd_w(g, idx, mask, h),
        "bwd_h": lambda: mp.maxpool_head_bwd_h(g, idx, mask, w),
    }[which]
    with pytest.raises(RuntimeError, match="no autograd"):
        call()
    with torch.no_grad():
        call()


def test_mlm_maxpool_routes_by_grad_mode():
    """Grad on: the Function (a grad_fn); no_grad: the ingest wrapper."""
    jcfg = jbert.config_from_preset("tiny", vocab_size=300, compute_dtype=jnp.float32)
    model = _port_model(jcfg, jbert.init(jax.random.PRNGKey(0), jcfg))
    x = torch.randn(2, 7, jcfg.hidden_size)
    mask = torch.ones(2, 7, dtype=torch.int32)
    calls = _calls(mp.maxpool_head_argmax_reference)
    assert model.mlm_maxpool(x, mask).grad_fn is not None
    assert _calls(mp.maxpool_head_argmax_reference) == calls + 1
    with torch.no_grad():
        before = _calls(mp.maxpool_head_reference)
        assert model.mlm_maxpool(x, mask).grad_fn is None
        assert _calls(mp.maxpool_head_reference) == before + 1


def _bwd_args(B=2, L=8, D=32, V=64):
    return (torch.zeros(B, V), torch.zeros(B, V, dtype=torch.int32),
            torch.ones(B, L, dtype=torch.int32), torch.zeros(V, D, dtype=torch.bfloat16))


@pytest.mark.parametrize("case,exc", [
    ("ok", None), ("g_bf16", TypeError), ("idx_int64", TypeError), ("w_float", TypeError),
    ("idx_shape", ValueError), ("D_not_multiple_of_8", ValueError), ("D_above_max", ValueError),
    ("w_misaligned", ValueError), ("g_not_contiguous", ValueError),
])
def test_backward_argument_checks(case, exc):
    """The backward kernels' checks run before any launch, on any device."""
    g, idx, mask, w = _bwd_args()
    if case == "g_bf16":
        g = g.bfloat16()
    elif case == "idx_int64":
        idx = idx.long()
    elif case == "w_float":
        w = w.float()
    elif case == "idx_shape":
        idx = idx[:, :10]
    elif case == "D_not_multiple_of_8":
        w = torch.zeros(64, 20, dtype=torch.bfloat16)
    elif case == "D_above_max":
        w = torch.zeros(64, 1544, dtype=torch.bfloat16)
    elif case == "w_misaligned":
        w = torch.zeros(64 * 32 + 1, dtype=torch.bfloat16)[1:].view(64, 32)
    elif case == "g_not_contiguous":
        g = torch.zeros(64, 2).t()
    if exc is None:
        mp.check_bwd_args(g, idx, mask, w, max_dim=1536)
    else:
        with pytest.raises(exc):
            mp.check_bwd_args(g, idx, mask, w, max_dim=1536)

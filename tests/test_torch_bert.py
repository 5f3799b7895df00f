"""The port's BERT-MLM module against the JAX package's functional BERT, with
the same weights (`params_from_jax`) and the same numpy inputs.

Tolerances: in fp32 the two compute the same arithmetic in another summation
order, so 1e-5 absolute on values of order 1-4. In bf16 the frameworks round
at different places (GEMM epilogues, GELU, the embedding sum), so a value may
differ by a bf16 rounding step or two: 2^-6 of the largest magnitude.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_sparse_model_tuning_sample_tpu.models import bert as jbert
from opensearch_sparse_model_tuning_sample_tpu.models import hf_import as jhf
from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert
from opensearch_sparse_model_tuning_sample_torch.models import hf_import as thf
from opensearch_sparse_model_tuning_sample_torch.models.convert import params_from_jax

torch.set_num_threads(2)


def _port_cfg(jcfg, compute_dtype):
    return tbert.BertConfig(**{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tbert.BertConfig)
        if f.name not in ("param_dtype", "compute_dtype")
    }, compute_dtype=compute_dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """Per compute dtype: (JAX cfg, tied params, untied params, port cfg, ids, mask)."""
    jcfg = jbert.config_from_preset("tiny", vocab_size=2000,
                                    compute_dtype=jnp.dtype(request.param))
    params = jbert.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    untied = jax.tree_util.tree_map(lambda x: x, params)
    untied["mlm_head"] = dict(params["mlm_head"], decoder=jnp.asarray(
        rng.normal(size=(jcfg.padded_vocab_size, jcfg.hidden_size)).astype(np.float32) * 0.02))
    ids = rng.integers(5, 2000, size=(3, 40)).astype(np.int32)
    mask = (np.arange(40)[None] < np.array([40, 17, 3])[:, None]).astype(np.int32)
    return jcfg, params, untied, _port_cfg(jcfg, getattr(torch, request.param)), ids, mask


@pytest.mark.parametrize("untied", [False, True])
@pytest.mark.parametrize("what", ["encode_hidden", "mlm_logits", "mlm_maxpool"])
def test_bert_matches_jax(pair, untied, what):
    jcfg, tied_p, untied_p, tcfg, ids, mask = pair
    params = untied_p if untied else tied_p
    model = tbert.from_state_dict(
        tcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg),
        torch.device("cpu"))
    assert (model.mlm_head.decoder is not None) == untied
    jh = jbert.encode_hidden(params, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        th = model.encode_hidden(torch.from_numpy(ids), torch.from_numpy(mask))
        if what == "encode_hidden":
            ref, got = jh, th
        elif what == "mlm_logits":
            ref, got = jbert.mlm_logits(params, jcfg, jh), model.mlm_logits(th)
        else:
            ref = jbert.mlm_maxpool(params, jcfg, jh, jnp.asarray(mask))
            got = model.mlm_maxpool(th, torch.from_numpy(mask))
    ref, got = _np(ref), _np(got)
    assert got.shape == ref.shape
    if tcfg.compute_dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=2**-6 * np.abs(ref).max())


def test_init_is_seeded_and_pads_vocab_rows():
    cfg = tbert.config_from_preset("tiny", vocab_size=1000)
    a, b = tbert.init_state_dict(cfg, seed=1), tbert.init_state_dict(cfg, seed=1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.attention.query.weight"],
                           tbert.init_state_dict(cfg, seed=2)["layers.0.attention.query.weight"])
    assert a["embeddings.word_embeddings"].shape[0] == 1024
    assert bool((a["embeddings.word_embeddings"][1000:] == 0).all())


def test_hf_import_reads_the_jax_checkpoint_exactly(tiny_model, tmp_path):
    """A checkpoint the JAX package writes loads in the port with the very
    weights params_from_jax gives."""
    ckpt = str(tmp_path / "ckpt")
    jhf.save_checkpoint(tiny_model, ckpt)
    cfg, sd, idf = thf.load_checkpoint(ckpt)
    assert cfg.hidden_size == tiny_model.cfg.hidden_size
    assert cfg.padded_vocab_size == tiny_model.cfg.padded_vocab_size
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, tiny_model.params["bert"]), cfg)
    assert sorted(sd) == sorted(ref)
    for k in ref:
        torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0, msg=k)
    assert idf is None  # no idf.json when the idf is frozen


@pytest.mark.parametrize("model_type", ["t5", "distilbert-sinusoidal"])
def test_hf_import_raises_on_layouts_not_ported(tmp_path, model_type):
    """RoBERTa and DistilBERT import (tests/test_torch_backbones.py); other
    families, and DistilBERT's sinusoidal positions, still raise."""
    body = {"model_type": model_type, "vocab_size": 10}
    if model_type == "distilbert-sinusoidal":
        body = {"model_type": "distilbert", "vocab_size": 10, "sinusoidal_pos_embds": True}
    p = tmp_path / "config.json"
    p.write_text(json.dumps(body))
    with pytest.raises(thf.UnsupportedArchitecture):
        thf.config_from_hf_json(str(p))


def test_hf_import_names_missing_keys(tiny_model, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    jhf.save_checkpoint(tiny_model, ckpt)
    from safetensors.numpy import load_file

    sd = load_file(os.path.join(ckpt, "model.safetensors"))
    del sd["bert.encoder.layer.1.output.dense.weight"]
    cfg = thf.config_from_hf_json(os.path.join(ckpt, "config.json"))
    with pytest.raises(thf.UnsupportedArchitecture, match="layer.1.output.dense"):
        thf.params_from_state_dict(sd, cfg)


def _bert_qkv(B, L, H, hd, dtype, seed):
    """q, k, v [B, L, H, hd] as BERT's projections give them (views of one
    [B, L, H·hd] product each) and a key mask of rows of other live
    lengths: a full row, padded rows and an all-padding row."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, L, H * hd, generator=g).to(dtype).view(B, L, H, hd)
               for _ in range(3))
    lens = torch.tensor([L, L - 5, L // 2, 7, 1, 0][:B])
    mask = (torch.arange(L)[None, :] < lens[:, None]).to(torch.int64)
    return q, k, v, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("hd,H,L", [(64, 12, 80), (16, 2, 70)])
def test_plain_chain_equals_the_fused_kernels_plain_version(dtype, hd, H, L):
    """BERT's plain attention chain is the function the fused kernel
    computes (`ops.attention.attention_reference`, its plain version), at
    BERT's head dims, over rows of other live lengths with key padding
    (an all-padding row too): in float32 to float32 rounding, in bf16
    within one bf16 rounding of the context's scale."""
    from opensearch_sparse_model_tuning_sample_torch.ops import attention as at

    q, k, v, mask = _bert_qkv(6, L, H, hd, dtype, seed=hd + L)
    got = tbert.attention_chain(q, k, v, mask)
    want = at.attention_reference(q, k, v, mask)
    assert got.shape == want.shape == q.shape and got.dtype == want.dtype == dtype
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    else:
        scale = want.abs().amax(dim=(-2, -1), keepdim=True)
        assert bool(((got - want).abs() <= 2**-8 * scale).all()), float((got - want).abs().max())


@pytest.mark.parametrize("case", ["inference", "dropout", "autograd"])
def test_bert_attention_takes_the_plain_chain_off_the_card(case):
    """On the CPU, in training with dropout, and with autograd on, every
    layer's attention takes the plain chain (`encoder.attn.plain_chain`
    counts one a layer) and the fused kernel neither launches nor runs its
    plain version: the kernel serves inference on a card only."""
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    cfg = tbert.config_from_preset("tiny", vocab_size=1000)
    model = tbert.from_state_dict(cfg, tbert.init_state_dict(cfg, seed=0), torch.device("cpu"))
    ids = torch.randint(5, 1000, (3, 24), generator=torch.Generator().manual_seed(1))
    mask = (torch.arange(24)[None, :] < torch.tensor([24, 9, 2])[:, None]).long()
    names = ["encoder.attn.plain_chain", "attn.launches.attention_global_kernel",
             "attn.plain_calls.attention_reference", "encoder.attn.pairs.global"]
    tracing.reset(names)
    if case == "inference":
        with torch.inference_mode():
            h = model.encode_hidden(ids, mask)
    elif case == "dropout":
        with torch.no_grad():
            h = model.encode_hidden(ids, mask, dropout_key=(0, 1))
    else:
        h = model.encode_hidden(ids, mask)
        assert h.requires_grad
    c = tracing.counters()
    assert [c.get(n, 0) for n in names] == [cfg.num_hidden_layers, 0, 0, 0]


def test_fused_attention_splits_a_batch_over_the_kernels_grid():
    """`fused_attention` covers a batch of more (doc, head) pairs than one
    launch of the kernel's grid takes (65 535) in launches of at most
    65 535 // H docs, and joins their contexts in order: at 8 192 heads,
    16 docs take launches of 7, 7 and 2, and equal one call over the whole
    batch (on the CPU each launch is the plain version, counted once a
    call), with the pair counter the same as one call's."""
    from opensearch_sparse_model_tuning_sample_torch.ops import attention as at
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    q, k, v, mask = _bert_qkv(6, 4, 8192, 16, torch.float32, seed=3)
    q, k, v = (torch.cat([t, t.flip(0), t[:4]]) for t in (q, k, v))  # 16 docs
    mask = torch.cat([mask, mask.flip(0), mask[:4]])
    names = ["attn.plain_calls.attention_reference", "encoder.attn.pairs.global"]
    tracing.reset(names)
    got = tbert.fused_attention(q, k, v, mask)
    split = [tracing.counters().get(n, 0) for n in names]
    tracing.reset(names)
    want = at.attention_reference(q, k, v, mask)
    assert split == [3, at.computed_pairs(16, 4, 0)]
    assert got.shape == want.shape == q.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)

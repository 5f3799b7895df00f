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

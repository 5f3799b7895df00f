"""The port's RoBERTa and DistilBERT layouts against `transformers` and the
JAX package: import, forward, export both ways, and a RoBERTa checkpoint
directory through `build_model`.

Checkpoints are random-init tiny `transformers` models (no network).
Tolerances:
  * MLM logits in fp32 compute against transformers: 2e-4 absolute plus
    1e-3 relative (the same products summed in another order);
  * weights imported by both packages, and the bytes both exports write:
    equal;
  * the encoder's reps (bf16 compute, the production head) against the
    JAX package's from the same checkpoint: 2e-2 absolute plus 2e-2
    relative (bf16 rounds at other places in the two frameworks), and
    against log1p(relu) of transformers' fp32 logits 2e-2 absolute plus
    5e-2 relative.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from opensearch_sparse_model_tuning_sample_tpu.models import hf_import as jhf
from opensearch_sparse_model_tuning_sample_tpu.models import sparse_encoder as jse
from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert
from opensearch_sparse_model_tuning_sample_torch.models import hf_import as thf
from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
from opensearch_sparse_model_tuning_sample_torch.models.convert import params_from_jax
from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import ByteLevelBPETokenizer

torch.set_num_threads(2)
CPU = torch.device("cpu")

_BPE_CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "sparse retrieval with learned representations",
    "a byte level tokenizer handles any utf-8 input",
]


def _hf_model(layout):
    if layout == "roberta":
        cfg = transformers.RobertaConfig(
            vocab_size=384, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=40, type_vocab_size=1,
            pad_token_id=1, bos_token_id=0, eos_token_id=2)
        cls = transformers.RobertaForMaskedLM
    else:
        cfg = transformers.DistilBertConfig(vocab_size=64, dim=32, n_layers=2, n_heads=2,
                                            hidden_dim=64, max_position_embeddings=32,
                                            pad_token_id=0)
        cls = transformers.DistilBertForMaskedLM
    torch.manual_seed(0)
    return cls(cfg).eval()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    out = {}
    for layout in ("roberta", "distilbert"):
        d = str(tmp_path_factory.mktemp(layout))
        m = _hf_model(layout)
        m.save_pretrained(d)
        out[layout] = (d, m)
    return out


def _inputs(layout, seed, B=3, L=12):
    vocab, pad = (384, 1) if layout == "roberta" else (64, 0)
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, size=(B, L)).astype(np.int64)
    mask = np.zeros((B, L), np.int64)
    for i, n in enumerate(rng.integers(2, L + 1, size=B)):
        ids[i, n:] = pad
        mask[i, :n] = 1
    mask[0] = 1
    ids[0] = rng.integers(4, vocab, size=L)
    return ids, mask


def _port_logits(cfg, sd, ids, mask):
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    bert = tbert.from_state_dict(cfg32, sd, CPU)
    with torch.no_grad():
        hidden = bert.encode_hidden(torch.from_numpy(ids), torch.from_numpy(mask))
        return bert.mlm_logits(hidden)[:, :, : cfg.vocab_size].numpy()


@pytest.mark.parametrize("layout", ["roberta", "distilbert"])
def test_forward_matches_transformers(ckpts, layout):
    """RoBERTa: positions from the pad offset, the one token-type row and
    the gelu-pinned head; DistilBERT: the renamed leaves, no token
    types, the vocab_transform/vocab_projector head."""
    d, hf_model = ckpts[layout]
    cfg, sd, _ = thf.load_checkpoint(d)
    assert cfg.model_type == layout
    if layout == "roberta":
        assert (cfg.position_style, cfg.head_act, cfg.pad_token_id) == ("from_pad_offset", "gelu", 1)
        assert cfg.max_position_embeddings == 40
        assert cfg.layer_norm_eps == hf_model.config.layer_norm_eps
    else:
        assert cfg.use_token_type is False and cfg.type_vocab_size == 1
    ids, mask = _inputs(layout, seed=1)
    with torch.no_grad():
        want = hf_model(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask)).logits.numpy()
    got = _port_logits(cfg, sd, ids, mask)
    sel = mask.astype(bool)
    np.testing.assert_allclose(got[sel], want[sel], atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("layout", ["roberta", "distilbert"])
def test_import_equals_the_jax_import(ckpts, layout):
    """Both packages read the same config and the same weights:
    params_from_jax of JAX's import is the port's import, bit for bit."""
    d, _ = ckpts[layout]
    jcfg, jparams, _ = jhf.load_checkpoint(d)
    cfg, sd, _ = thf.load_checkpoint(d)
    for f in ("model_type", "position_style", "use_token_type", "head_act", "vocab_size",
              "hidden_size", "num_hidden_layers", "intermediate_size", "max_position_embeddings",
              "type_vocab_size", "layer_norm_eps", "hidden_act", "pad_token_id"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    assert sorted(sd) == sorted(ref)
    for k in ref:
        torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0, msg=k)


class _Tok:  # save_checkpoint only asks the tokenizer to save itself
    special_token_ids = ()

    def save_pretrained(self, out):
        pass


@pytest.mark.parametrize("layout", ["roberta", "distilbert"])
def test_export_round_trips_both_ways(ckpts, layout, tmp_path):
    """The port's export reloads in transformers with the original logits,
    writes the bytes the JAX package's export writes, and a JAX-written
    checkpoint loads back in the port with the same weights."""
    d, hf_model = ckpts[layout]
    cfg, sd, _ = thf.load_checkpoint(d)
    model = tse.SparseEncoderModel(cfg=cfg, bert=tbert.from_state_dict(cfg, sd, CPU),
                                   idf_vector=torch.ones(cfg.vocab_size), tokenizer=_Tok())
    out = str(tmp_path / "port")
    thf.save_checkpoint(model, out)
    re = transformers.AutoModelForMaskedLM.from_pretrained(out).eval()
    ids, mask = _inputs(layout, seed=2, B=2, L=9)
    with torch.no_grad():
        a = hf_model(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask)).logits
        b = re(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask)).logits
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)

    jcfg, jparams, _ = jhf.load_checkpoint(d)
    jmodel = jse.SparseEncoderModel(
        cfg=jcfg, params={"bert": jparams, "idf_vector": jnp.ones((jcfg.vocab_size,))},
        tokenizer=_Tok(), _special_mask=np.zeros((jcfg.vocab_size,), np.float32))
    jout = str(tmp_path / "jax")
    jhf.save_checkpoint(jmodel, jout)
    for f in ("model.safetensors", "config.json"):
        with open(os.path.join(out, f), "rb") as x, open(os.path.join(jout, f), "rb") as y:
            assert x.read() == y.read(), f
    cfg2, sd2, _ = thf.load_checkpoint(jout)
    assert cfg2 == cfg
    for k in sd:
        torch.testing.assert_close(sd2[k], sd[k], rtol=0, atol=0, msg=k)


@pytest.fixture(scope="module")
def roberta_dir(ckpts, tmp_path_factory):
    """A RoBERTa checkpoint dir with a byte-level BPE tokenizer and an
    idf.json, as tests/test_backbones.py builds it for the JAX package."""
    tokenizers = pytest.importorskip("tokenizers")
    d, hf_model = ckpts["roberta"]
    ckpt = str(tmp_path_factory.mktemp("roberta_dir"))
    for f in os.listdir(d):
        os.link(os.path.join(d, f), os.path.join(ckpt, f))
    bpe = tokenizers.ByteLevelBPETokenizer()
    bpe.train_from_iterator(_BPE_CORPUS * 4, vocab_size=320, min_frequency=1,
                            special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"])
    bpe.save_model(ckpt)
    with open(os.path.join(ckpt, "idf.json"), "w") as f:
        json.dump({"<s>": 0.5}, f)
    return ckpt, hf_model


def test_build_model_from_a_roberta_dir(roberta_dir):
    """A RoBERTa checkpoint dir builds the port's encoder with its BPE
    tokenizer: reps equal log1p(relu) of transformers' max-pooled logits
    and the JAX package's reps from the same dir; the inference-free
    query path zeroes the BPE special tokens."""
    ckpt, hf_model = roberta_dir
    model = tse.build_model(model_name_or_path=ckpt, device="cpu")
    assert model.cfg.model_type == "roberta"
    assert isinstance(model.tokenizer, ByteLevelBPETokenizer)
    texts = ["the quick brown fox", "sparse retrieval"]
    enc = tse.get_batch_encoder(model, max_length=16)
    reps = enc.encode_batch(texts)
    assert reps.shape == (2, model.cfg.vocab_size) and (reps >= 0).all()

    f = model.tokenizer(texts, max_length=16, pad_to=16)
    with torch.no_grad():
        logits = hf_model(input_ids=torch.tensor(f["input_ids"].astype(np.int64)),
                          attention_mask=torch.tensor(f["attention_mask"].astype(np.int64))).logits
    want = np.log1p(np.maximum(np.max(logits.numpy() * f["attention_mask"][:, :, None], 1), 0))
    np.testing.assert_allclose(reps, want, atol=2e-2, rtol=5e-2)

    jmodel = jse.build_model(model_name_or_path=ckpt)
    jreps = jse.get_batch_encoder(jmodel, max_length=16, seq_buckets=[16]).encode_batch(texts)
    np.testing.assert_allclose(reps, jreps, atol=2e-2, rtol=2e-2)

    q = enc.encode_batch(["fox"], inf_free=True)
    assert set(model.tokenizer.special_token_ids) == set(jmodel.tokenizer.special_token_ids)
    for sid in model.tokenizer.special_token_ids:
        assert q[0, sid] == 0.0

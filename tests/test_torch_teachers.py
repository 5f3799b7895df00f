"""The port's teachers (train/teachers.py) against the JAX package's, from the
same weights (`params_from_jax`, or one checkpoint both load): sparse and
dense reps, min-max normalisation, ensemble scores grouped and in-batch
over sparse, dense and remote teachers, `build_teacher` from a JAX-saved
checkpoint, a no-MLM-head dense dump and a DistilBERT dir natively, and the
host fallback for a layout the importer does not map.

Tolerances:
  * fp32 compute: reps 1e-5 absolute plus 1e-4 relative (the same products
    summed in another order);
  * bf16 compute (the production precision): sparse reps 3e-2 absolute
    plus 3e-2 relative, dense reps 2e-2 absolute (bf16 rounds at other
    places in the two frameworks, and JAX's teacher pools through its scan
    head, the port's through the production head's plain version);
  * ensemble scores: the reps' relative tolerance (1e-5 in fp32, 3e-2 in
    bf16) carried through the min-max, which divides each row by its
    score range (`_minmax_atol`);
  * min-max normalisation: 1e-6; a tied row is exactly 0;
  * host teachers (both packages run the same transformers module on the
    CPU): embeddings 1e-5.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from opensearch_sparse_model_tuning_sample_tpu.models import hf_import as jhf
from opensearch_sparse_model_tuning_sample_tpu.train import teachers as jt
from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert
from opensearch_sparse_model_tuning_sample_torch.models.convert import params_from_jax
from opensearch_sparse_model_tuning_sample_torch.ops.activations import special_token_mask
from opensearch_sparse_model_tuning_sample_torch.train import teachers as tt

torch.set_num_threads(2)
CPU = torch.device("cpu")

TEXTS = ["the capital of france is paris", "sparse retrieval uses inverted indexes",
         "bert computes contextual token representations", "a", "tensor processing units",
         "the eiffel tower is in paris france"]
VOCAB_WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "world", "dense",
               "teacher", "foreign", "layout", "a", "b", "c", "query", "doc"]


def _port_teacher(j, compute_dtype=torch.bfloat16):
    """The port's Teacher with the weights of JAX teacher `j`."""
    cfg = tbert.config_from_preset("tiny", vocab_size=j.cfg.vocab_size,
                                   compute_dtype=compute_dtype)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, j.params), cfg)
    bert = tbert.from_state_dict(cfg, sd, CPU).requires_grad_(False)
    smask = (special_token_mask(j.tokenizer.special_token_ids, cfg.vocab_size)
             if j.kind == "sparse" else None)
    return tt.Teacher(kind=j.kind, bert=bert, tokenizer=j.tokenizer,
                      special_mask=smask, pooling=j.pooling)


def _fp32(j):
    return dataclasses.replace(j, cfg=dataclasses.replace(j.cfg, compute_dtype=jnp.float32))


@pytest.fixture(scope="module")
def jteachers():
    return {"sparse": jt.build_teacher("sparse", "tiny", seed=11),
            "dense": jt.build_teacher("dense", "tiny", seed=12)}


def _feats(tok, texts, L=16):
    f = tok(texts, max_length=L, pad_to=L)
    return ({"input_ids": jnp.asarray(f["input_ids"]), "attention_mask": jnp.asarray(f["attention_mask"])},
            {"input_ids": torch.from_numpy(f["input_ids"]),
             "attention_mask": torch.from_numpy(f["attention_mask"])})


@pytest.mark.parametrize("kind,pooling,dtype", [
    ("sparse", "cls", "float32"), ("sparse", "cls", "bfloat16"),
    ("dense", "cls", "float32"), ("dense", "cls", "bfloat16"),
    ("dense", "mean", "float32"), ("dense", "mean", "bfloat16")])
def test_teacher_reps_match_jax(jteachers, kind, pooling, dtype):
    j = dataclasses.replace(jteachers[kind], pooling=pooling)
    if dtype == "float32":
        j = _fp32(j)
    t = _port_teacher(j, getattr(torch, dtype))
    jf, tf = _feats(j.tokenizer, TEXTS)
    want = np.asarray(jt.teacher_rep(j, jf))
    got = tt.teacher_rep(t, tf)
    assert not got.requires_grad and got.dtype == torch.float32
    got = got.numpy()
    if kind == "sparse":
        assert got.shape == (len(TEXTS), j.cfg.vocab_size)
        assert (got[:, j.tokenizer.special_token_ids] == 0).all() and (got >= 0).all()
    else:
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    elif kind == "sparse":
        np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2)


def test_minmax_normalize_matches_jax_and_zeroes_a_tied_row():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(5, 7)).astype(np.float32) * 30
    s[2] = 4.25  # every score of the row ties
    s[3, :3] = s[3, 3]  # a partial tie
    got = tt.minmax_normalize(torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, np.asarray(jt.minmax_normalize(jnp.asarray(s))), atol=1e-6)
    assert (got[2] == 0).all()
    assert got[0].min() == 0 and got[0].max() == pytest.approx(1.0, abs=1e-6)


def _minmax_atol(raw, rel, scale):
    """Per-row tolerance of an ensemble's scores: min-max divides each
    teacher's row by its score range, so a raw-score error of `rel` times
    the row's largest |score| becomes 2 rel max|s| / range after it (the
    row's min and max may move apart), averaged over the teachers and
    times the score scale."""
    per = [2 * rel * np.abs(s).max(1) / (s.max(1) - s.min(1)) for s in raw]
    return scale * np.mean(per, axis=0)[:, None]


@pytest.mark.parametrize("in_batch", [False, True], ids=["grouped", "in_batch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ensemble_scores_match_jax(jteachers, in_batch, dtype):
    """Sparse + dense (mean pooling) + remote: [B, G] grouped or [B, B*G]
    in-batch scores, each teacher min-max normalised, the mean times the
    score scale. The tolerance is the reps' (1e-5 relative in fp32, 3e-2 in
    bf16) carried through the min-max (`_minmax_atol`)."""
    B, G, E = 2, 3, 24
    rng = np.random.default_rng(5)
    jts, tts = [], []
    for kind in ("sparse", "dense"):
        j = dataclasses.replace(jteachers[kind], pooling="mean")
        j = j if dtype == "bfloat16" else _fp32(j)
        jts.append(j)
        tts.append(_port_teacher(j, getattr(torch, dtype)))
    jts.append(jt.Teacher(kind="remote", model_id="store:x"))
    tts.append(tt.Teacher(kind="remote", model_id="store:x"))
    qs, ds = TEXTS[:B], [TEXTS[(i * 5 + 1) % len(TEXTS)] + " paris" * (i % 3) for i in range(B * G)]
    jq, jd, tq, td = [], [], [], []
    for j in jts[:2]:
        a, b = _feats(j.tokenizer, qs, 8)
        c, d = _feats(j.tokenizer, ds, 16)
        jq.append(a), tq.append(b), jd.append(c), td.append(d)
    q_emb = rng.normal(size=(B, E)).astype(np.float16)
    d_emb = rng.normal(size=(B * G, E)).astype(np.float16)
    jq.append({"embeddings": jnp.asarray(q_emb)}), jd.append({"embeddings": jnp.asarray(d_emb)})
    tq.append({"embeddings": torch.from_numpy(q_emb)}), td.append({"embeddings": torch.from_numpy(d_emb)})

    jens = jt.TeacherEnsemble(jts, score_scale=30.0, use_in_batch_negatives=in_batch)
    tens = tt.TeacherEnsemble(tts, score_scale=30.0, use_in_batch_negatives=in_batch)
    want = np.asarray(jens.get_scores(jq, jd))
    got = tens.get_scores(tq, td)
    assert not got.requires_grad and got.dtype == torch.float32
    assert got.shape == ((B, B * G) if in_batch else (B, G))
    raw = []
    for j, q, d in zip(jts, jq, jd):
        qr, dr = np.asarray(jt.teacher_rep(j, q), np.float64), np.asarray(jt.teacher_rep(j, d), np.float64)
        raw.append(qr @ dr.T if in_batch else np.einsum("bgv,bv->bg", dr.reshape(B, G, -1), qr))
    atol = _minmax_atol(raw, 1e-5 if dtype == "float32" else 3e-2, 30.0)
    assert (np.abs(got.numpy() - want) <= atol).all(), (got, want, atol)
    with pytest.raises(ValueError, match="3 teachers"):
        tens.get_scores(tq[:2], td[:2])


def test_build_teacher_from_a_jax_checkpoint(tiny_model, tmp_path):
    """A checkpoint the JAX package saved builds the same frozen teacher in
    both packages (bf16, the production precision); the port's is an
    eval-mode module whose parameters need no gradient."""
    ckpt = str(tmp_path / "ckpt")
    jhf.save_checkpoint(tiny_model, ckpt)
    j = jt.build_teacher("sparse", ckpt)
    t = tt.build_teacher("sparse", ckpt, device="cpu")
    assert t.kind == "sparse" and not t.bert.training
    assert not any(p.requires_grad for p in t.bert.parameters())
    jf, tf = _feats(j.tokenizer, TEXTS)
    np.testing.assert_allclose(tt.teacher_rep(t, tf).numpy(), np.asarray(jt.teacher_rep(j, jf)),
                               atol=3e-2, rtol=3e-2)
    # a preset teacher is a seeded random init; store: and remote are remote
    a, b = (tt.build_teacher("dense", "tiny", seed=3, device="cpu") for _ in range(2))
    for (k, x), y in zip(a.bert.state_dict().items(), b.bert.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    assert tt.build_teacher("sparse", "store:/x", device="cpu").kind == "remote"
    assert tt.build_teacher("remote", "7", device="cpu").kind == "remote"


def test_build_ensemble_takes_the_config_dict():
    kw = {"types": ["sparse", "dense"], "model_ids": ["tiny", "tiny"],
          "pooling": ["cls", "mean"], "score_scale": 20}
    ens = tt.build_ensemble(kw, use_in_batch_negatives=True, device="cpu")
    assert [t.kind for t in ens.teachers] == ["sparse", "dense"]
    assert [t.pooling for t in ens.teachers] == ["cls", "mean"]
    assert ens.score_scale == 20 and ens.use_in_batch_negatives
    # teacher i draws its init from seed 10 + i
    ref = tbert.init_state_dict(ens.teachers[1].bert.cfg, 11)["embeddings.word_embeddings"]
    torch.testing.assert_close(ens.teachers[1].bert.embeddings.word_embeddings.data, ref)
    with pytest.raises(ValueError, match="2 types, 1 model_ids"):
        tt.build_ensemble({"types": ["sparse", "dense"], "model_ids": ["tiny"]}, False,
                          device="cpu")


def _write_vocab(path):
    with open(path, "w") as f:
        f.write("\n".join(VOCAB_WORDS) + "\n")


@pytest.fixture(scope="module")
def foreign_dirs(tmp_path_factory):
    """A dense BERT dump with no MLM head (relu, eps 1e-5), a DistilBERT
    checkpoint, and an ELECTRA one, which the importer does not map."""
    root = tmp_path_factory.mktemp("foreign")
    out = {}
    common = dict(vocab_size=len(VOCAB_WORDS), num_hidden_layers=2, num_attention_heads=2,
                  max_position_embeddings=64)
    for name, cfg, cls in (
        ("bert_dense", transformers.BertConfig(hidden_size=32, intermediate_size=64,
                                               hidden_act="relu", layer_norm_eps=1e-5, **common),
         transformers.BertModel),
        ("distilbert", transformers.DistilBertConfig(
            vocab_size=len(VOCAB_WORDS), dim=32, n_layers=2, n_heads=2, hidden_dim=64,
            max_position_embeddings=64), transformers.DistilBertForMaskedLM),
        ("electra", transformers.ElectraConfig(embedding_size=32, hidden_size=32,
                                               intermediate_size=64, **common),
         transformers.ElectraModel),
    ):
        d = str(root / name)
        os.makedirs(d)
        _write_vocab(f"{d}/vocab.txt")
        torch.manual_seed(0)
        m = cls(cfg).eval()
        m.save_pretrained(d)
        if name == "electra":
            transformers.ElectraTokenizerFast(vocab_file=f"{d}/vocab.txt").save_pretrained(d)
        out[name] = (d, m)
    return out


@pytest.mark.parametrize("name,pooling", [("bert_dense", "mean"), ("distilbert", "cls")])
def test_foreign_dense_teachers_host_natively(foreign_dirs, name, pooling):
    """A no-MLM-head dense dump (a fresh head, as JAX imports it) and a
    DistilBERT checkpoint import natively, and their fp32 dense reps match
    transformers' and JAX's."""
    d, hf_model = foreign_dirs[name]
    t = tt.build_teacher("dense", d, pooling=pooling, device="cpu")
    j = jt.build_teacher("dense", d, pooling=pooling)
    assert t.kind == "dense" and j.kind == "dense" and t.host_model is None
    t32 = dataclasses.replace(t, bert=tbert.from_state_dict(
        dataclasses.replace(t.bert.cfg, compute_dtype=torch.float32), t.bert.state_dict(), CPU))
    jf, tf = _feats(t.tokenizer, ["hello world", "dense teacher foreign layout"], L=12)
    got = tt.teacher_rep(t32, tf).numpy()
    np.testing.assert_allclose(got, np.asarray(jt.teacher_rep(_fp32(j), jf)), atol=1e-5, rtol=1e-4)
    base = hf_model.distilbert if name == "distilbert" else hf_model
    with torch.no_grad():
        hidden = base(input_ids=tf["input_ids"].long(),
                      attention_mask=tf["attention_mask"].long()).last_hidden_state
        m = tf["attention_mask"].float()[:, :, None]
        pooled = (hidden * m).sum(1) / m.sum(1) if pooling == "mean" else hidden[:, 0]
        want = torch.nn.functional.normalize(pooled, p=2, dim=1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_unmapped_layout_falls_back_to_the_host(foreign_dirs):
    """ELECTRA does not map, so both packages host it through transformers;
    its embeddings and the ensemble's scores agree."""
    d, _ = foreign_dirs["electra"]
    t = tt.build_teacher("dense", d, pooling="mean", device="cpu")
    j = jt.build_teacher("dense", d, pooling="mean")
    assert t.kind == "hf" and j.kind == "hf" and t.host_model.device == CPU
    tens = tt.TeacherEnsemble([t], score_scale=30.0)
    jens = jt.TeacherEnsemble([j], score_scale=30.0)
    assert tens.has_host
    batch = {"teacher_q": [{"texts": ("hello world", "query doc")}],
             "teacher_d": [{"texts": tuple(f"doc {w}" for w in "a b c a b c".split())}]}
    tb, jb = tens.host_precompute(batch), jens.host_precompute(batch)
    for key in ("teacher_q", "teacher_d"):
        np.testing.assert_allclose(tb[key][0]["embeddings"].numpy(), jb[key][0]["embeddings"],
                                   atol=1e-5)
    q, d = (np.asarray(jb[k][0]["embeddings"], np.float64) for k in ("teacher_q", "teacher_d"))
    raw = np.einsum("bgv,bv->bg", d.reshape(2, 3, -1), q)
    diff = np.abs(tens.get_scores(tb["teacher_q"], tb["teacher_d"]).numpy()
                  - np.asarray(jens.get_scores(jb["teacher_q"], jb["teacher_d"])))
    assert (diff <= _minmax_atol([raw], 1e-5, 30.0)).all(), diff


def test_unloadable_teacher_names_both_errors(tmp_path, monkeypatch):
    """A bert-typed dir whose weights do not map, with no tokenizer either:
    the error names the native and the host failure. Without transformers
    the host path names the package it needs."""
    from safetensors.numpy import save_file

    d = tmp_path / "alien"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "model_type": "bert", "vocab_size": 16, "hidden_size": 8, "num_hidden_layers": 1,
        "num_attention_heads": 2, "intermediate_size": 16}))
    save_file({"encoder.blocks.0.attn.qkv.weight": np.zeros((8, 24), np.float32)},
              str(d / "model.safetensors"))
    with pytest.raises(ValueError, match="loads neither natively .*word_embeddings.* nor "
                                         "through the host path"):
        tt.build_teacher("sparse", str(d), device="cpu")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="opensearch_sparse_model_tuning_sample_torch.*"
                                          "needs the transformers package"):
        tt.build_teacher("hf", str(d), device="cpu")

"""The port's ModernBERT (`models/modernbert.py`, `ops/attention.py`) on the
CPU, against the benchmark's plain reference (`lsr_bench/reference/
modernbert.py`), at test widths with the published structure: 6 layers
(two periods, globals at 0 and 3), D 64, 4 heads, I 96, window 16, vocab
512, seeded random weights, rows of lengths 5-40 with padding.

  * encode_hidden, mlm_maxpool and encode_doc against the reference;
  * what each layer kind sees (a perturbation), its RoPE θ, and the first
    layer's identity norm;
  * the plain attention path's key blocks against dense masked attention;
  * ingest through the length-sorted chunks against the reference's rows;
  * the HF import of a synthetic checkpoint and its export round trip;
  * the benchmark's new cell at test widths: correct, and its faults not.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from lsr_bench.reference import modernbert as ref_mb
from opensearch_sparse_model_tuning_sample_torch.eval.beir import ingest
from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig
from opensearch_sparse_model_tuning_sample_torch.models import hf_import, modernbert
from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import (
    ByteLevelBPETokenizer, WordPieceTokenizer)
from opensearch_sparse_model_tuning_sample_torch.ops import attention as at

torch.set_num_threads(2)

B, L = 4, 40
LENS = [40, 23, 5, 31]


def _cfg(compute=torch.float32, **kw):
    return modernbert.config_from_preset("modernbert-tiny", compute_dtype=compute, **kw)


def _model(cfg, seed=0):
    return modernbert.from_state_dict(cfg, modernbert.init_state_dict(cfg, seed), "cpu")


def _ref(cfg, model, precision="fp32"):
    keys = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return ref_mb.Encoder(keys, {k: v.float() for k, v in model.state_dict().items()}, precision)


def _batch(seed=1):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 512, (B, L), generator=g)
    mask = (torch.arange(L)[None, :] < torch.tensor(LENS)[:, None]).to(torch.int32)
    return ids * mask, mask


# float32 compute: the two differ only in the order of fp32 sums. bfloat16
# compute: every product's operands are rounded to 8 bits of mantissa
# (2^-9 relative) through 6 layers and the head: a few 1e-2 of the values'
# scale, against O(1) hidden states (LayerNorm output) and logits.
TOL = {torch.float32: 2e-5, torch.bfloat16: 6e-2}


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_hidden_and_maxpool_match_the_reference(compute):
    cfg = _cfg(compute)
    model = _model(cfg)
    ids, mask = _batch()
    with torch.no_grad():
        hid = model.encode_hidden(ids, mask)
        pooled = model.mlm_maxpool(hid, mask)[:, : cfg.vocab_size]
        ref = _ref(cfg, model)
        rh = ref.hidden(ids, mask)
        rp = ref.pooled(rh, mask)
    live = mask.bool()
    assert hid.dtype == compute
    assert float((hid.float() - rh).abs()[live].max()) <= TOL[compute]
    assert float((pooled - rp).abs().max()) <= TOL[compute] * float(rp.abs().max())


def test_encode_doc_matches_the_reference_rep():
    cfg = _cfg()
    model = tse.SparseEncoderModel(cfg, _model(cfg), torch.ones(cfg.vocab_size),
                                   WordPieceTokenizer.from_pretrained(None))
    ids, mask = _batch(2)
    with torch.no_grad():
        rep = tse.encode_doc(model, ids, mask)
        want = _ref(cfg, model.bert).rep(ids, mask)
    assert rep.shape == (B, cfg.vocab_size)
    assert float((rep - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("layer", [0, 1, 3, 5])
def test_a_token_moves_a_local_layer_within_its_window_and_a_global_everywhere(layer):
    """The derivative of a layer's output along a change of token j alone
    (forward mode, so a change too small to survive rounding still
    shows): a local layer's output moves at |i - j| <= local_attention / 2
    and nowhere else; a global layer's at every position."""
    cfg = _cfg()
    model = _model(cfg, seed=4)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1, L, cfg.hidden_size), generator=g)
    j = 20
    change = torch.zeros_like(x)
    change[0, j] = torch.randn(cfg.hidden_size, generator=g)
    mask = torch.ones((1, L), dtype=torch.int32)
    rope = model._rope_for(L, cfg.rope_theta(layer), "cpu")
    with torch.no_grad():
        _, moved = torch.func.jvp(lambda y: model.layers[layer](y, mask, rope), (x,), (change,))
    moved = moved.abs().amax(-1)[0] > 0
    near = (torch.arange(L) - j).abs() <= cfg.local_attention // 2
    assert cfg.is_global(layer) == (layer % 3 == 0)
    if cfg.is_global(layer):
        assert bool(moved.all())
    else:
        assert bool((moved == near).all()), moved.nonzero().flatten().tolist()


@pytest.mark.parametrize("kind", ["global", "local"])
def test_rope_theta_follows_the_layer_kind(kind):
    """Changing one kind's θ changes the output, and the port still equals
    the reference under the changed θ: each layer takes its kind's θ."""
    base = _cfg()
    assert [base.rope_theta(i) for i in range(6)] == [160000.0, 1e4, 1e4, 160000.0, 1e4, 1e4]
    cfg = dataclasses.replace(base, **{f"{kind}_rope_theta": 500.0})
    ids, mask = _batch(5)
    live = mask.bool()
    with torch.no_grad():
        m0, m1 = _model(base, seed=6), _model(cfg, seed=6)
        h0, h1 = m0.encode_hidden(ids, mask), m1.encode_hidden(ids, mask)
        want = _ref(cfg, m1).hidden(ids, mask)
    assert float((h1 - h0).abs()[live].max()) > 10 * TOL[torch.float32]
    assert float((h1 - want).abs()[live].max()) <= TOL[torch.float32]


def test_the_first_layer_takes_no_attention_norm():
    """Layer 0 reads the embeddings' norm as it is: no attn_norm module or
    weight (HF's nn.Identity), while every later layer has one; a scale on
    layer 1's attn_norm moves the output, and nothing named for layer 0 can."""
    cfg = _cfg()
    model = _model(cfg)
    names = set(model.state_dict())
    assert model.layers[0].attn_norm is None and "layers.0.attn_norm.weight" not in names
    assert all(f"layers.{i}.attn_norm.weight" in names for i in range(1, 6))
    ids, mask = _batch(6)
    with torch.no_grad():
        h0 = model.encode_hidden(ids, mask)
        model.layers[1].attn_norm.weight.mul_(2.0)
        assert float((model.encode_hidden(ids, mask) - h0).abs().max()) > 1e-3


def _dense_attention(q, k, v, mask, window):
    """Naive dense masked attention in float64."""
    q, k, v = (t.double().transpose(1, 2) for t in (q, k, v))
    n = q.shape[2]
    ok = mask.bool()[:, None, None, :].expand(-1, 1, n, n)
    if window:
        pos = torch.arange(n)
        ok = ok & ((pos[:, None] - pos[None, :]).abs() <= window)
    logits = (q @ k.transpose(-1, -2)) / q.shape[-1] ** 0.5
    p = torch.softmax(logits.masked_fill(~ok, float("-inf")), -1)
    return (p @ v).transpose(1, 2)


@pytest.mark.parametrize("n,window", [(200, 0), (200, 8), (333, 64), (64, 64)])
def test_plain_attention_blocks_equal_dense_masked_attention(n, window):
    """The plain path computes only the key blocks the kernel visits: on
    the live query rows it equals dense masked attention, and it counts
    the kernel's pairs (a window's computed pairs stay under 4 x the real
    P(n), dense would be n / (2w + 1) times)."""
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    g = torch.Generator().manual_seed(n + window)
    q, k, v = (torch.randn((3, n, 2, 16), generator=g) for _ in range(3))
    mask = (torch.arange(n)[None, :] < torch.tensor([n, n // 2, 9])[:, None]).int()
    mask[0, 5:40] = 0  # interior holes in a full row
    kind = "local" if window else "global"
    before = tracing.counters().get("encoder.attn.pairs." + kind, 0)
    got = at.attention(q, k, v, mask, window)
    counted = tracing.counters()["encoder.attn.pairs." + kind] - before
    assert counted == at.computed_pairs(3, n, window)
    want = _dense_attention(q, k, v, mask, window)
    assert float((got.double() - want).abs()[mask.bool()].max()) <= 1e-5
    if window == 64:  # the published half-window, on the kernel's 64-key tiles
        real = sum(min(i + window, n - 1) - max(i - window, 0) + 1 for i in range(n))
        assert real <= counted / 3 < 4 * real


def _tiny_vocab(tmp_path):
    words = [w for w in ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu nu "
                         "xi omicron pi rho sigma tau upsilon phi chi psi omega one two three "
                         "four five six seven eight nine ten").split()]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    return words


def test_ingest_through_sorted_chunks_matches_the_reference_rows(tmp_path):
    """`eval/beir.py::ingest` with a ModernBERT model (length-sorted chunks,
    batches at multiples of 64, some docs past max_length): each stored
    row, read back in corpus order, holds the reference rep's top terms at
    their weights (bf16 storage: 2^-8 of the doc's largest weight)."""
    words = _tiny_vocab(tmp_path)
    model = tse.build_model(arch="modernbert-tiny", tokenizer_name=str(tmp_path), seed=3,
                            device="cpu", compute_dtype=torch.float32)
    rng = np.random.default_rng(9)
    corpus = [(f"d{i}", " ".join(rng.choice(words, int(n))))
              for i, n in enumerate(rng.integers(3, 160, size=40))]
    l_max = 24
    index = ingest(corpus, model, str(tmp_path / "out"), "t", max_length=128, batch_size=4,
                   index_cfg=IndexConfig(engine="sparse", l_max=l_max))
    index.save(str(tmp_path / "saved"))
    blob = np.load(tmp_path / "saved" / "index.npz")
    w = (blob["weights_bf16"].astype(np.uint32) << 16).view(np.float32) \
        if "weights_bf16" in blob else blob["weights"].astype(np.float32)
    with open(tmp_path / "saved" / "doc_ids.json") as f:
        assert json.load(f) == [d for d, _ in corpus]
    enc = _ref(model.cfg, model.bert)
    for i, (_, text) in enumerate(corpus):
        f = model.tokenizer([text], max_length=128)
        ids, mask = torch.from_numpy(f["input_ids"]), torch.from_numpy(f["attention_mask"])
        with torch.no_grad():
            ref = enc.rep(ids, mask)[0]
        top = torch.topk(ref, l_max)
        want = {int(t): float(v) for t, v in zip(top.indices, top.values) if v > 0}
        got = {int(t): float(x) for t, x in zip(blob["tokens"][i], w[i]) if x > 0}
        tol = float(ref.max()) * 2 ** -8
        assert set(got) <= set(int(t) for t in torch.nonzero(ref > 0))
        for t, x in got.items():
            assert abs(x - float(ref[t])) <= tol
        assert min(got.values()) >= min(want.values()) - tol and len(got) == len(want)


def test_the_large_preset_is_the_published_model():
    cfg = modernbert.config_from_preset("modernbert-large")
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.intermediate_size, cfg.vocab_size, cfg.max_position_embeddings) == (
                1024, 28, 16, 2624, 50368, 8192)
    assert [i for i in range(28) if cfg.is_global(i)] == list(range(0, 28, 3))
    assert {cfg.window(i) for i in range(28)} == {0, 64}
    shapes = modernbert.state_dict_names(cfg)
    n = sum(int(np.prod(s)) for s in shapes.values())
    pad = (cfg.padded_vocab_size - cfg.vocab_size) * (cfg.hidden_size + 1)
    assert n - pad == 395_881_664  # the published 395 M
    assert tse._doubling_buckets(8192) == [64, 128, 256, 512, 1024, 2048, 4096, 8192]
    assert list(tse._batch_lengths(np.array([1, 700, 5000, 8192]), 1, 8192)) == [
        64, 704, 5056, 8192]


def _bpe_tokenizer_json(path):
    letters = list("abcdefghijklmnopqrstuvwxyz") + ["Ġ"]
    vocab = {t: i for i, t in enumerate(["[UNK]", "[CLS]", "[SEP]", "[PAD]", "[MASK]"]
                                       + letters + ["Ġt", "he", "Ġthe", "in"])}
    blob = {"model": {"type": "BPE", "vocab": vocab,
                      "merges": ["Ġ t", "h e", "Ġt he", "i n"]}}
    path.write_text(json.dumps(blob))
    return vocab


def _write_hf_checkpoint(d, cfg, sd):
    from safetensors.numpy import save_file

    d.mkdir()
    hf = {k if k.startswith(("head.", "decoder.")) else "model." + k: v.numpy()
          for k, v in sd.items()}
    save_file(hf, str(d / "model.safetensors"))
    config = {"architectures": ["ModernBertForMaskedLM"], "model_type": "modernbert",
              "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
              "num_hidden_layers": cfg.num_hidden_layers,
              "num_attention_heads": cfg.num_attention_heads,
              "intermediate_size": cfg.intermediate_size,
              "max_position_embeddings": cfg.max_position_embeddings,
              "global_attn_every_n_layers": 3, "local_attention": cfg.local_attention,
              "global_rope_theta": 160000.0, "local_rope_theta": 10000.0, "norm_eps": 1e-5,
              "norm_bias": False, "attention_bias": False, "mlp_bias": False,
              "classifier_bias": False, "decoder_bias": True, "tie_word_embeddings": True,
              "hidden_activation": "gelu", "classifier_activation": "gelu",
              "pad_token_id": 0, "embedding_dropout": 0.0}
    (d / "config.json").write_text(json.dumps(config))
    return hf


def test_hf_checkpoint_imports_equal_to_the_seeded_module_and_round_trips(tmp_path):
    """A synthetic ModernBertForMaskedLM checkpoint (HF names, tied decoder
    left out, a BPE tokenizer.json with [CLS]-style specials) loads through
    build_model equal to the module it was written from; the export writes
    HF's names (the decoder too) and loads back the same."""
    from safetensors.numpy import load_file

    cfg = _cfg()
    sd = modernbert.init_state_dict(cfg, seed=7)
    d = tmp_path / "ckpt"
    hf = _write_hf_checkpoint(d, cfg, sd)
    vocab = _bpe_tokenizer_json(d / "tokenizer.json")
    model = tse.build_model(model_name_or_path=str(d), device="cpu")
    assert isinstance(model.bert, modernbert.ModernBertForMaskedLM)
    assert isinstance(model.tokenizer, ByteLevelBPETokenizer)
    assert (model.tokenizer.bos_id, model.tokenizer.eos_id) == (vocab["[CLS]"], vocab["[SEP]"])
    got = model.bert.state_dict()
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    out = tmp_path / "export"
    hf_import.save_checkpoint(model, str(out))
    written = load_file(str(out / "model.safetensors"))
    assert set(written) == set(hf) | {"decoder.weight"}
    assert all(np.array_equal(written[k], hf[k]) for k in hf)
    again = tse.build_model(model_name_or_path=str(out), device="cpu")
    assert all(torch.equal(again.bert.state_dict()[k], sd[k]) for k in sd)


@pytest.mark.parametrize("key", ["norm_bias", "mlp_bias"])
def test_a_biased_modernbert_checkpoint_is_refused(tmp_path, key):
    cfg = _cfg()
    d = tmp_path / "ckpt"
    _write_hf_checkpoint(d, cfg, modernbert.init_state_dict(cfg))
    config = json.loads((d / "config.json").read_text())
    (d / "config.json").write_text(json.dumps({**config, key: True}))
    with pytest.raises(hf_import.UnsupportedArchitecture, match=key):
        hf_import.load_checkpoint(str(d))


def test_the_trainer_refuses_a_modernbert_backbone():
    from opensearch_sparse_model_tuning_sample_torch.train.trainer import Trainer

    cfg = _cfg()
    model = tse.SparseEncoderModel(cfg, _model(cfg), torch.ones(cfg.vocab_size),
                                   WordPieceTokenizer.from_pretrained(None))
    with pytest.raises(NotImplementedError, match="ModernBERT"):
        Trainer(model, None, None, None)


@pytest.mark.parametrize("compute,fault", [("float32", None), ("bfloat16", "token"),
                                           ("bfloat16", "answer")])
def test_the_benchmark_cell_at_test_widths(monkeypatch, compute, fault):
    """`modernbert-longdoc-ingest` cut to test widths (vocab kept at the
    WordPiece's, which the traffic's ids need) and to short docs on the
    CPU: in float32 its row_gap reads round-off alone; a planted fault is
    not correct."""
    from lsr_bench import harness

    tiny = dict(vocab_size=30522, hidden_size=64, num_hidden_layers=6, num_attention_heads=4,
                intermediate_size=96, max_position_embeddings=512, local_attention=16)
    monkeypatch.setitem(modernbert.PRESETS, "modernbert-cputest", tiny)
    cell = harness.load_cell("modernbert-longdoc-ingest")
    cell.config = {**cell.config, **tiny}
    cell.traffic = {**cell.traffic, "corpus_docs": 12, "corpora": 1, "batch_size": 2,
                    "max_length": 128, "doc_words": {"median": 60, "sigma": 0.5, "min": 10,
                                                     "max": 200}}
    cell.device, cell.seed = "cpu", 2**31 + 99
    cell.overrides["compute"] = compute
    if fault:
        cell.overrides["fault"] = fault
    out = harness.run_cell(cell, 0.2, False, time.perf_counter())
    if fault:
        assert not out["correct"], out["checks"]
    else:
        assert out["correct"] and out["checks"]["row_gap"]["value"] <= 1e-5, out["checks"]

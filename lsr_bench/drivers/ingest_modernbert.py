"""Long-document ingest with a ModernBERT encoder: `drivers/ingest.py`'s
traffic (repeated calls of the port's `eval/beir.py::ingest`, each over one
whole corpus) on a ModernBERT configuration.

Set-up builds the program's model first, as `common.program_model` does
(the port's preset whose sizes are the configuration's, holding the seed's
weights from `weights_modernbert.py`), so a port without ModernBERT fails
at once; then the corpora, as `drivers/ingest.py` makes them, and the
warm-up calls. Each unit returns, beside `drivers/ingest.py`'s counts,
the work of ModernBERT's forward (`flops`: the local layers' windowed pairs,
not L²) and each attention kind's real query-key pairs and least time
(`modernbert_roofline.py`). `attn_real_pairs` sums the real pairs of every
call the process ran, warm-up included, for `attn_waste_share.ingest`.

The output check is `row_gap`, as in `drivers/ingest.py`, against the
plain reference `reference/modernbert.py`, a few docs of like length at a
time. The `answer` fault hooks the encoder at the traffic's own
`max_length`.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from .. import roofline
from ..gen import text as textgen
from ..reference import modernbert as ref_mb
from ..reference.wordpiece import WordPiece
from ..trace import Ranges
from ..weights_modernbert import make_weights, model_keys
from . import ingest
from . import modernbert_roofline as work
from .common import HeadRange


def preset_for(m: dict) -> str:
    """The port's ModernBERT preset whose sizes are these model keys."""
    from opensearch_sparse_model_tuning_sample_torch.models import modernbert

    for name in modernbert.PRESETS:
        cfg = modernbert.config_from_preset(name)
        if all(getattr(cfg, k) == v for k, v in m.items()):
            return name
    raise KeyError(f"no ModernBERT preset of the port has the sizes {m}")


class Driver(ingest.Driver):
    def __init__(self, cell):
        # not Base.__init__: its model_keys reads BERT and DistilBERT keys
        self.cell = cell
        self.m = model_keys(cell.config)
        self.t = cell.traffic
        self.ranges = Ranges()
        self.devices = cell.devices()
        self.dev = self.devices[0]
        self.fault = cell.overrides.get("fault")
        self.attn_real_pairs = {"global": 0.0, "local": 0.0}

    def weights(self):
        return make_weights(self.m, self.cell.seed, self.dev)

    def program_model(self, idf_path=None):
        """The port's sparse encoder holding the seed's weights, as
        `common.program_model` makes it: the preset's module loaded with
        `weights()`, the bundled tokenizer with its native path, its idf
        zero-padded to the model's vocab (as `build_model` pads it)."""
        from opensearch_sparse_model_tuning_sample_torch.core.device import resolve_device
        from opensearch_sparse_model_tuning_sample_torch.models import modernbert
        from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as se
        from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import (
            load_idf_weights, load_tokenizer)

        compute = getattr(torch, self.cell.overrides.get("compute", "bfloat16"))
        cfg = modernbert.config_from_preset(preset_for(self.m), compute_dtype=compute)
        bert = modernbert.from_state_dict(cfg, self.weights(), resolve_device(self.dev))
        tok = load_tokenizer(None)
        tok.try_attach_native()
        raw = np.asarray(load_idf_weights(idf_path, tok), np.float32)
        idf = np.zeros(cfg.vocab_size, np.float32)
        idf[:min(len(raw), cfg.vocab_size)] = raw[:cfg.vocab_size]
        return se.SparseEncoderModel(cfg, bert, torch.from_numpy(idf), tok)

    def setup(self):
        from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig

        self.model = self.program_model()
        t, seed = self.t, self.cell.seed
        rng = np.random.default_rng(seed & (2**63 - 1))
        words = textgen.Words(t["zipf"])
        n, dw = int(t["corpus_docs"]), t["doc_words"]
        self.corpora, self.tokens = [], []
        for k in range(int(t["corpora"])):
            lens = textgen.lognormal_lengths(n, dw["median"], dw["sigma"], dw["min"], dw["max"],
                                             rng)
            texts = textgen.make_texts(words, lens, rng)
            self.corpora.append([(f"c{k}d{i}", s) for i, s in enumerate(texts)])
            self.tokens.append(textgen.token_counts(lens, int(t["max_length"])))
        self.head = HeadRange(self.ranges, "maxpool_head")
        _plant(self.fault, self.model, int(t["max_length"]))
        self.index_cfg = IndexConfig(engine=t["engine"], l_max=int(t["l_max"]))
        self.out = tempfile.TemporaryDirectory(prefix="lsr_bench_ingest_")
        self.calls = []
        for k in range(int(t["warmup_calls"])):
            self._ingest(k % len(self.corpora), f"warm{k}")

    def _ingest(self, k: int, name: str):
        for kind in self.attn_real_pairs:
            self.attn_real_pairs[kind] += work.pairs(self.m, self.tokens[k], kind)
        return super()._ingest(k, name)

    def unit(self) -> dict:
        j = len(self.calls)
        k = j % len(self.corpora)
        with self.ranges("ingest"):
            index = self._ingest(k, f"c{j}")
        self.calls.append((k, index))
        tok = self.tokens[k]
        m = self.m
        return {"calls": 1, "docs": len(tok), "tokens": int(tok.sum()),
                "flops": work.forward_flops(m, tok),
                "head_flops": roofline.head_flops(tok.sum(), m["hidden_size"], m["vocab_size"]),
                "attn_pairs_global": work.pairs(m, tok, "global"),
                "attn_pairs_local": work.pairs(m, tok, "local"),
                "attn_global_bound_s": work.attn_bound_s(m, tok, "global"),
                "attn_local_bound_s": work.attn_bound_s(m, tok, "local")}

    def reference_reps(self, k: int, precision: str, batch: int = 4):
        """(doc indices, rep [b, V] float32) of corpus k's docs, a few of
        like length at a time, from the plain reference."""
        enc = ref_mb.Encoder(self.m, self.weights(), precision)
        wp = WordPiece()
        L = int(self.t["max_length"])
        texts = [s for _, s in self.corpora[k]]
        order = np.argsort(self.tokens[k], kind="stable")
        with torch.no_grad():
            for s in range(0, len(order), batch):
                sel = order[s:s + batch]
                b = wp.batch([texts[i] for i in sel], L, buckets=None)
                ids = torch.from_numpy(b["input_ids"]).to(self.dev)
                mask = torch.from_numpy(b["attention_mask"]).to(self.dev)
                yield sel, enc.rep(ids, mask)


def _plant(fault, model, max_length: int):
    """`drivers/ingest.py`'s faults, the `answer` fault on the encoder that
    ingest takes at `max_length`."""
    if fault != "answer":
        return ingest._plant(fault, model)
    from opensearch_sparse_model_tuning_sample_torch.models.sparse_encoder import \
        get_batch_encoder

    enc = get_batch_encoder(model, max_length=max_length, do_count=True, scope=("ingest", 0, 1))
    inner = enc.resolve_chunk_sparse

    def altered(handle, n_valid):
        idx, vals = inner(handle, n_valid)
        vals = vals.copy()
        vals[0, 0] *= 1.5
        return idx, vals

    enc.resolve_chunk_sparse = altered


"""Ingest traffic: repeated calls of the port's `eval/beir.py::ingest`, each
over one whole corpus (encode, sparsify to the top `l_max`, add, finalize,
write the corpus statistic).

Set-up makes `corpora` corpora of `corpus_docs` docs from the seed (word
counts lognormal at fixed quantiles, so every seed does the same work),
the model from the seed's weights, and warms up with `warmup_calls` calls
(every chunk of these corpora takes the 512 bucket, so one call
warms every shape). The window takes the corpora in turn, one call a unit (the range
`lsr.ingest`), and keeps each call's index.

The output check takes one call of the window, drawn from the seed, and
holds its index rows (as `SparseIndex.save` writes them) to the plain
reference's encoding of the same corpus. (The corpus statistic is not
compared: under random weights nearly every pooled logit is positive, so
it reads about 1.0 for every token whatever the precision.)
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from .. import roofline
from ..gen import text as textgen
from ..reference import bert as ref_bert
from ..reference.wordpiece import WordPiece
from .common import Base, HeadRange, free


class Driver(Base):
    def setup(self):
        from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig

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
        self.model = self.program_model()
        _plant(self.fault, self.model)
        self.index_cfg = IndexConfig(engine=t["engine"], l_max=int(t["l_max"]))
        self.out = tempfile.TemporaryDirectory(prefix="lsr_bench_ingest_")
        self.calls = []
        for k in range(int(t["warmup_calls"])):
            self._ingest(k % len(self.corpora), f"warm{k}")

    def _ingest(self, k: int, name: str):
        from opensearch_sparse_model_tuning_sample_torch.eval.beir import ingest

        t = self.t
        return ingest(self.corpora[k], self.model, self.out.name, name,
                      max_length=int(t["max_length"]), batch_size=int(t["batch_size"]),
                      index_cfg=self.index_cfg)

    def unit(self) -> dict:
        j = len(self.calls)
        k = j % len(self.corpora)
        with self.ranges("ingest"):
            index = self._ingest(k, f"c{j}")
        self.calls.append((k, index))
        tok = self.tokens[k]
        return {"calls": 1, "docs": len(tok), "tokens": int(tok.sum()),
                "flops": roofline.encoder_forward_flops(self.m, tok),
                "head_flops": roofline.head_flops(tok.sum(), self.m["hidden_size"],
                                                  self.m["vocab_size"])}

    def end_to_end(self, w) -> dict:
        return {"ingest_docs_per_s": w.total("docs") / w.seconds}

    def attempted(self, w) -> int:
        return int(w.total("docs"))

    # ------------------------------------------------------------ check
    def program_rows(self):
        """The drawn call's corpus and its stored rows (tokens, float32
        weights, by doc)."""
        c = int(np.random.default_rng(self.cell.seed + 7).integers(len(self.calls)))
        k, index = self.calls[c]
        path = os.path.join(self.out.name, f"saved{c}")
        index.save(path)
        blob = np.load(os.path.join(path, "index.npz"))
        w = (blob["weights_bf16"].astype(np.uint32) << 16).view(np.float32) \
            if "weights_bf16" in blob else blob["weights"].astype(np.float32)
        toks = blob["tokens"].astype(np.int64)
        with open(os.path.join(path, "doc_ids.json")) as f:
            pos = {d: i for i, d in enumerate(json.load(f))}
        order = [pos[d] for d, _ in self.corpora[k]]
        return k, toks[order], w[order]

    def release(self):
        self.head.restore()
        self.model = self.calls = None
        free(*self.devices)

    def reference_reps(self, k: int, precision: str, batch: int = 32):
        """(doc indices, rep [b, V] float32) of corpus k's docs, by batches
        of docs of like length, from the plain reference."""
        ref_bert.set_precision()
        enc = ref_bert.Encoder(self.m, self.weights(), precision)
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

    def compare(self, toks, w, reps) -> dict:
        """row_gap: per doc, the widest of |stored weight - reference's
        (rounded to the stored bfloat16)| over the stored terms and the
        reference weight by which an unstored term beats a stored one (or,
        where fewer than l_max are stored, any unstored term's), over the
        doc's largest reference weight; the widest over the docs."""
        l_max = int(self.t["l_max"])
        gap = 0.0
        for sel, r in reps:
            tk = torch.from_numpy(toks[sel]).to(self.dev)
            wt = torch.from_numpy(w[sel]).to(self.dev)
            # padding slots hold token 0 at weight 0: a max keeps a stored token 0
            prog = torch.zeros_like(r).scatter_reduce_(1, tk, wt, "amax")
            kept = prog > 0
            rb = r.to(torch.bfloat16).float()
            val = torch.where(kept, (prog - rb).abs(), 0.0).amax(1)
            rmin = torch.where(kept, r, float("inf")).amin(1)
            out_max = torch.where(kept, 0.0, r).amax(1)
            full = kept.sum(1) >= l_max
            sel_gap = torch.where(full, torch.relu(out_max - rmin), out_max)
            doc = torch.maximum(val, sel_gap) / r.amax(1).clamp_min(1e-30)
            gap = max(gap, float(doc.max()))
        return {"row_gap": gap}

    def readings(self) -> dict:
        k, toks, w = self.program_rows()
        self.release()
        nums = self.compare(toks, w, self.reference_reps(k, "fp32"))
        self.out.cleanup()
        return nums

    def control(self) -> dict:
        """The fp8 reference in the program's place: its own top-l_max rows
        (stored in bfloat16), against the float32 reference."""
        k = int(np.random.default_rng(self.cell.seed + 7).integers(len(self.calls)))
        self.release()
        self.out.cleanup()
        l_max, n = int(self.t["l_max"]), len(self.corpora[k])
        toks = np.zeros((n, l_max), np.int64)
        w = np.zeros((n, l_max), np.float32)
        for sel, r in self.reference_reps(k, "fp8"):
            v, i = torch.topk(r, l_max, dim=1)
            v = torch.where(v > 0, v, 0.0).to(torch.bfloat16).float()
            toks[sel], w[sel] = i.cpu().numpy(), v.cpu().numpy()
        return self.compare(toks, w, self.reference_reps(k, "fp32"))


def _plant(fault, model):
    """Faults planted in the program for the output check's own tests."""
    if fault is None:
        return
    if fault == "token":  # one token of every doc altered where the tokenizer makes it
        inner = model.tokenizer.encode_bucketed

        def altered(*a, **k):
            f = inner(*a, **k)
            ids = f["input_ids"].copy()
            ids[:, 1] = (ids[:, 1] + 1) % 30522
            return {**f, "input_ids": ids}

        model.tokenizer.encode_bucketed = altered
    elif fault == "answer":  # one weight of every chunk's rows altered where it is made
        from opensearch_sparse_model_tuning_sample_torch.models.sparse_encoder import \
            get_batch_encoder

        enc = get_batch_encoder(model, max_length=512, do_count=True, scope=("ingest", 0, 1))
        inner = enc.resolve_chunk_sparse

        def altered(handle, n_valid):
            idx, vals = inner(handle, n_valid)
            vals = vals.copy()
            vals[0, 0] *= 1.5
            return idx, vals

        enc.resolve_chunk_sparse = altered
    else:
        raise ValueError(f"unknown fault {fault!r}")

"""Collators: rows -> numpy batches for the train step.

The PyTorch port's copy of the JAX package's `data/collator.py` (reference
collator.py:11-184): one collator per data_type, queries and flattened docs
tokenized once, scores -> a [B, G] array when present. Every batch is padded
to one of `seq_buckets` (the largest bucket is the cap), so the same rows
give the same arrays in both packages. Doc groups are flattened group-major
([q0_pos, q0_n1, ..., q1_pos, ...]) with the positive first in each group,
the layout the losses assume (ops/losses.py).

Teacher features (KD teacher ensembles, remote embeddings) are not ported
yet: asking for them raises NotImplementedError naming the ROADMAP item.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_KD_TEACHERS = ("teacher features are not ported to the PyTorch package yet "
                "(ROADMAP Queue 1: KD teachers)")


class _CollatorBase:
    def __init__(
        self,
        tokenizer,
        max_length: int,
        seq_buckets: Optional[Sequence[int]] = None,
        teacher_tokenizer_ids: Sequence[str] = (),
        embedding_store=None,
        teacher_ensemble=None,
    ):
        if teacher_tokenizer_ids or embedding_store is not None or teacher_ensemble is not None:
            raise NotImplementedError(_KD_TEACHERS)
        self.tokenizer = tokenizer
        buckets = sorted(seq_buckets or [64, 128, 256, 512])
        # the largest bucket is the cap: anything longer truncates there, so
        # every batch has a bucket shape
        self.cap = min(max_length, buckets[-1])
        self.buckets = [b for b in buckets if b <= self.cap] or [self.cap]

    def _encode(self, texts: Sequence[str]) -> Dict[str, np.ndarray]:
        return self.tokenizer.encode_bucketed(texts, self.cap, self.buckets)

    @staticmethod
    def _pad_feat(f: Dict[str, np.ndarray], L: int, pad_id: int):
        ids, am = f["input_ids"], f["attention_mask"]
        if ids.shape[1] < L:
            w = L - ids.shape[1]
            ids = np.pad(ids, ((0, 0), (0, w)), constant_values=pad_id)
            am = np.pad(am, ((0, 0), (0, w)))
        return {"input_ids": ids, "attention_mask": am}

    def _assemble(self, queries, docs, scores=None):
        qf = self._encode(queries)
        df = self._encode(docs)
        batch = {
            "q_input_ids": qf["input_ids"],
            "q_attention_mask": qf["attention_mask"],
            "d_input_ids": df["input_ids"],
            "d_attention_mask": df["attention_mask"],
        }
        if scores is not None and all(s is not None for row in scores for s in row):
            batch["scores"] = np.asarray(scores, dtype=np.float32)
        return batch


class PosNegsDataCollator(_CollatorBase):
    """Rows (query, pos, negs) -> groups [pos, *negs] flattened group-major
    (reference collator.py:134-178)."""

    def __call__(self, rows):
        queries = [q for q, _, _ in rows]
        docs = []
        for _, pos, negs in rows:
            docs.append(pos)
            docs.extend(negs)
        return self._assemble(queries, docs)


class KnowledgeDistillDataCollator(_CollatorBase):
    """Rows (query, docs, scores) -> flattened docs + [B, G] score array
    (reference collator.py:11-79)."""

    def __call__(self, rows):
        queries = [q for q, _, _ in rows]
        docs = [d for _, ds, _ in rows for d in ds]
        scores = [s for _, _, s in rows]
        return self._assemble(queries, docs, scores=scores)


COLLATOR_CLS_MAP = {
    "posnegs": PosNegsDataCollator,
    "kd": KnowledgeDistillDataCollator,
}


def build_collator(
    data_type: str,
    tokenizer,
    max_length: int,
    teacher_tokenizer_ids: Sequence[str] = (),
    seq_buckets: Optional[Sequence[int]] = None,
    embedding_store=None,
    teacher_ensemble=None,
):
    """Registry entry point (reference COLLATOR_CLS_MAP, collator.py:180-184)."""
    if data_type == "kd-ids":
        raise NotImplementedError(
            "the kd-ids collator is not ported to the PyTorch package yet "
            "(ROADMAP Queue 1: KD teachers)")
    return COLLATOR_CLS_MAP[data_type](
        tokenizer,
        max_length,
        seq_buckets=seq_buckets,
        teacher_tokenizer_ids=teacher_tokenizer_ids,
        embedding_store=embedding_store,
        teacher_ensemble=teacher_ensemble,
    )

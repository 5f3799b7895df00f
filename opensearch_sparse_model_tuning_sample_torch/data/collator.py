"""Collators: rows -> numpy batches for the train step.

The PyTorch port's copy of the JAX package's `data/collator.py` (reference
collator.py:11-184): one collator per data_type, queries and flattened docs
tokenized once per tokenizer in [student] + teachers, scores -> a [B, G]
array when present. Every batch is padded to one of `seq_buckets` (the
largest bucket is the cap), so the same rows give the same arrays in both
packages. Doc groups are flattened group-major ([q0_pos, q0_n1, ...,
q1_pos, ...]) with the positive first in each group, the layout the losses
assume (ops/losses.py).

Teacher features ride the batch as parallel lists `teacher_q` / `teacher_d`,
one dict per teacher: a native teacher's own token ids at the batch's
shared bucket, a host teacher's raw `texts`, or a remote teacher's pending
store fetch, which `resolve_pending` swaps for the prefetched `embeddings`
(reference collator.py:92-106, against the local embedding store).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def _is_remote_id(tid) -> bool:
    try:
        int(str(tid))
        return True
    except ValueError:
        return False


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
        self.tokenizer = tokenizer
        buckets = sorted(seq_buckets or [64, 128, 256, 512])
        # the largest bucket is the cap: anything longer truncates there, so
        # every batch has a bucket shape
        self.cap = min(max_length, buckets[-1])
        self.buckets = [b for b in buckets if b <= self.cap] or [self.cap]
        self.store = embedding_store
        # per-teacher feature specs: from the built ensemble's teacher kinds
        # (host teachers tokenize their own raw texts, native ones use their
        # own tokenizer), else from teacher_tokenizer_ids alone (numeric ids
        # are remote, paths or None a WordPiece tokenizer; reference
        # collator.py:23-52, 92-106)
        self.teachers: List[Dict] = []
        if teacher_ensemble is not None:
            ids = list(teacher_tokenizer_ids)
            for i, t in enumerate(teacher_ensemble.teachers):
                if t.kind == "remote":
                    tid = ids[i] if i < len(ids) else None
                    self._need_store(t.model_id)
                    self.teachers.append(
                        {"remote": True,
                         "model_id": int(tid) if _is_remote_id(tid) else t.model_id})
                elif t.kind == "hf":
                    self.teachers.append({"remote": False, "host": True})
                else:
                    t.tokenizer.try_attach_native()
                    self.teachers.append({"remote": False, "tokenizer": t.tokenizer})
            return
        from ..models.tokenizer import load_tokenizer

        for tid in teacher_tokenizer_ids:
            if _is_remote_id(tid):
                self._need_store(tid)
                self.teachers.append({"remote": True, "model_id": int(tid)})
            else:
                tok = load_tokenizer(tid if os.path.isdir(str(tid)) else None)
                tok.try_attach_native()
                self.teachers.append({"remote": False, "tokenizer": tok})

    def _need_store(self, tid):
        # fail here, not on an unresolved placeholder inside the train step
        if self.store is None:
            raise ValueError(
                f"remote teacher {tid!r} but no embedding store is configured (add "
                "'remote' to the kd ensemble types)")

    def _encode(self, texts: Sequence[str]) -> Dict[str, np.ndarray]:
        return self.tokenizer.encode_bucketed(texts, self.cap, self.buckets)

    def _bucket_for(self, longest: int) -> int:
        for b in self.buckets:
            if longest <= b:
                return b
        return self.cap

    @staticmethod
    def _pad_feat(f: Dict[str, np.ndarray], L: int, pad_id: int):
        ids, am = f["input_ids"], f["attention_mask"]
        if ids.shape[1] < L:
            w = L - ids.shape[1]
            ids = np.pad(ids, ((0, 0), (0, w)), constant_values=pad_id)
            am = np.pad(am, ((0, 0), (0, w)))
        return {"input_ids": ids, "attention_mask": am}

    def _teacher_features(self, queries, docs, native_feats, q_ids=None, d_ids=None):
        """Per-teacher parallel features: a native teacher's (q, d) features
        from `native_feats` (aligned with self.teachers, None for the
        others), a host teacher's raw texts, and for a remote teacher a
        placeholder that `resolve_pending` fills once the store's prefetch,
        registered here, lands."""
        teacher_q, teacher_d = [], []
        for t, nf in zip(self.teachers, native_feats):
            if t["remote"]:
                if q_ids is None or d_ids is None:
                    raise ValueError("remote teachers need kd-ids rows (q_id, d_ids)")
                mid = t["model_id"]
                self.store.register_task("vector_q", mid, list(q_ids))
                self.store.register_task("vector", mid, list(d_ids))
                teacher_q.append({"__pending__": ("vector_q", mid, tuple(q_ids))})
                teacher_d.append({"__pending__": ("vector", mid, tuple(d_ids))})
            elif t.get("host"):
                teacher_q.append({"texts": tuple(queries)})
                teacher_d.append({"texts": tuple(docs)})
            else:
                teacher_q.append(nf[0])
                teacher_d.append(nf[1])
        return teacher_q, teacher_d

    def resolve_pending(self, batch: Dict) -> Dict:
        """Swap remote placeholders for the prefetched embeddings (blocks on
        the store's per-key Event, reference async_embedding_server.py:80).
        Call it before the batch goes to the device."""
        if self.store is None:
            return batch
        out = dict(batch)
        for key in ("teacher_q", "teacher_d"):
            feats = batch.get(key)
            if not feats:
                continue
            resolved = []
            for f in feats:
                if "__pending__" in f:
                    table, mid, ids = f["__pending__"]
                    emb = self.store.fetch_embedding(table, mid, list(ids))
                    resolved.append({"embeddings": np.asarray(emb)})
                else:
                    resolved.append(f)
            out[key] = resolved
        return out

    def _assemble(self, queries, docs, scores=None, q_ids=None, d_ids=None):
        natives = [t for t in self.teachers if not t["remote"] and not t.get("host")]
        if not natives:
            qf = self._encode(queries)
            df = self._encode(docs)
        else:
            # one bucket shared by every tokenizer (the student's and the
            # native teachers'): each tokenizes once at the cap, and the
            # batch bucket fits the longest of them, so no teacher whose
            # tokenizer needs more tokens for the same text is truncated to
            # the student's bucket (the reference pads teachers to their
            # own length, collator.py:32-52)
            qf = self.tokenizer(queries, max_length=self.cap)
            df = self.tokenizer(docs, max_length=self.cap)
            raw = [(tok(queries, max_length=self.cap), tok(docs, max_length=self.cap))
                   for tok in (t["tokenizer"] for t in natives)]
            Lq = self._bucket_for(max([qf["input_ids"].shape[1]]
                                      + [r[0]["input_ids"].shape[1] for r in raw]))
            Ld = self._bucket_for(max([df["input_ids"].shape[1]]
                                      + [r[1]["input_ids"].shape[1] for r in raw]))
            qf = self._pad_feat(qf, Lq, self.tokenizer.pad_id)
            df = self._pad_feat(df, Ld, self.tokenizer.pad_id)
            raw = [(self._pad_feat(rq, Lq, t["tokenizer"].pad_id),
                    self._pad_feat(rd, Ld, t["tokenizer"].pad_id))
                   for (rq, rd), t in zip(raw, natives)]
        batch = {
            "q_input_ids": qf["input_ids"],
            "q_attention_mask": qf["attention_mask"],
            "d_input_ids": df["input_ids"],
            "d_attention_mask": df["attention_mask"],
        }
        if scores is not None and all(s is not None for row in scores for s in row):
            batch["scores"] = np.asarray(scores, dtype=np.float32)
        if self.teachers:
            it = iter(raw) if natives else iter(())
            native_feats = [None if (t["remote"] or t.get("host")) else next(it)
                            for t in self.teachers]
            batch["teacher_q"], batch["teacher_d"] = self._teacher_features(
                queries, docs, native_feats, q_ids, d_ids)
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


class KnowledgeDistillIdsDataCollator(_CollatorBase):
    """Rows (query, q_id, docs, d_ids, scores): kd, plus the remote
    teachers' prefetch registered by the ids (reference
    collator.py:82-131)."""

    def __call__(self, rows):
        queries = [q for q, *_ in rows]
        q_ids = [qid for _, qid, *_ in rows]
        docs = [d for _, _, ds, _, _ in rows for d in ds]
        d_ids = [d for _, _, _, dids, _ in rows for d in dids]
        scores = [s for *_, s in rows]
        return self._assemble(queries, docs, scores=scores, q_ids=q_ids, d_ids=d_ids)


COLLATOR_CLS_MAP = {
    "posnegs": PosNegsDataCollator,
    "kd": KnowledgeDistillDataCollator,
    "kd-ids": KnowledgeDistillIdsDataCollator,
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
    return COLLATOR_CLS_MAP[data_type](
        tokenizer,
        max_length,
        seq_buckets=seq_buckets,
        teacher_tokenizer_ids=teacher_tokenizer_ids,
        embedding_store=embedding_store,
        teacher_ensemble=teacher_ensemble,
    )

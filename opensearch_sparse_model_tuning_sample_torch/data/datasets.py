"""Datasets: host-side, indexable sequences over corpus and training rows.

The PyTorch port's copy of the JAX package's `data/datasets.py` (reference
dataset.py): the corpus views the eval path uses, the posnegs, KD and
KD-with-ids training datasets (strided KD group sampling :193-196, partial_shuffle
:22-40, the first_rank filter :174-179, posnegs chunking :329-358), MS MARCO
KD with its mojibake repair (:287-326), the MIRACL corpus and training rows
(:101-121, :361-386), the modulo host shard (:124-148) and the combined
multi-dataset batching (:389-444). Every class is a plain indexable sequence and all randomness is
numpy, seeded, so the same rows and seed give the same batches in both
packages.

Rows may come from HF `datasets.Dataset.load_from_disk` dirs or plain lists
of dicts: both are duck-typed on `column_names`.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _column_names(rows) -> List[str]:
    cols = getattr(rows, "column_names", None)
    if cols is not None:
        return list(cols)
    if len(rows) == 0:
        return []
    first = rows[0]
    return list(first.keys()) if isinstance(first, dict) else []


def partial_shuffle(lst: Sequence, swap_times,
                    rng: Optional[np.random.Generator] = None) -> List:
    """Soften a rank ordering with `swap_times` random pair swaps
    (reference dataset.py:22-40); >= n/2 swaps degenerates to a full
    shuffle. The KD dataset seeds one Generator per (shuffle_seed, row_idx),
    so every rank builds the same group list."""
    swap_times = int(swap_times)
    if swap_times <= 0:
        return list(lst)
    if rng is None:
        rng = np.random  # module-global stream (single process only)
    out = np.array(lst)
    n = len(out)
    if swap_times >= n // 2:
        rng.shuffle(out)
    else:
        pairs = rng.integers(0, n, size=(swap_times, 2)) if isinstance(
            rng, np.random.Generator
        ) else rng.randint(0, n, size=(swap_times, 2))
        for i, j in pairs:
            out[i], out[j] = out[j], out[i]
    return out.tolist()


def _first_rank_keep(row: Dict, thresh: int) -> bool:
    fr = row.get("first_rank", 1)
    return fr >= 0 and fr <= thresh


class KnowledgeDistillDataset:
    """{query, docs, scores} rows -> strided doc groups.

    For a row with n docs (rank-ordered) and group size `sample_num`,
    step = n // sample_num and group i (i < step) takes docs
    [i, i+step, i+2*step, ...], so each group spans the full rank range
    (reference dataset.py:193-196). Scores are multiplied by `score_scale`
    at access time; rows with a `first_rank` outside [0, first_rank_thresh]
    are dropped (:174-179)."""

    def __init__(
        self,
        all_data,
        sample_num: int = 2,
        swap_times=0,
        first_rank_thresh: int = 10000,
        score_scale: float = 1.0,
        shuffle_seed: int = 0,
        **_,
    ):
        assert sample_num >= 2
        if "first_rank" in _column_names(all_data):
            if hasattr(all_data, "filter"):
                all_data = all_data.filter(lambda r: _first_rank_keep(r, first_rank_thresh))
            else:
                all_data = [r for r in all_data if _first_rank_keep(r, first_rank_thresh)]
            logger.info("first_rank filter kept %d rows", len(all_data))

        self.all_data = all_data
        self.score_scale = score_scale
        self.has_scores = "scores" in _column_names(all_data)
        self.groups: List[Tuple[int, List[int]]] = []
        for row_idx in range(len(all_data)):
            n = len(all_data[row_idx]["docs"])
            order = list(range(n))
            if swap_times:
                # one Generator per (seed, row): the same on every rank and
                # independent of the order rows are visited in
                order = partial_shuffle(
                    order, swap_times, rng=np.random.default_rng([shuffle_seed, row_idx]),
                )
            step = n // sample_num
            for i in range(step):
                self.groups.append((row_idx, [order[k * step + i] for k in range(sample_num)]))
        logger.info("KnowledgeDistillDataset: %d rows -> %d groups (sample_num=%d)",
                    len(all_data), len(self.groups), sample_num)

    def __len__(self):
        return len(self.groups)

    def __getitem__(self, idx: int):
        row_idx, picks = self.groups[idx]
        row = self.all_data[row_idx]
        docs = [row["docs"][i] for i in picks]
        if self.has_scores:
            scores = [row["scores"][i] * self.score_scale for i in picks]
        else:
            scores = [None] * len(picks)
        return row["query"], docs, scores


class KnowledgeDistillIdsDataset(KnowledgeDistillDataset):
    """KD rows that also carry q_id/d_ids for precomputed ("remote")
    teachers (reference dataset.py:220-284): the parent's first_rank filter
    and strided grouping; the reference's ids variant applies no
    score_scale, so it is pinned to 1."""

    def __init__(self, all_data, sample_num: int = 2, swap_times=0,
                 first_rank_thresh: int = 10000, shuffle_seed: int = 0, **_):
        super().__init__(all_data, sample_num=sample_num, swap_times=swap_times,
                         first_rank_thresh=first_rank_thresh, score_scale=1.0,
                         shuffle_seed=shuffle_seed)

    def __getitem__(self, idx: int):
        row_idx, picks = self.groups[idx]
        row = self.all_data[row_idx]
        docs = [row["docs"][i] for i in picks]
        d_ids = [row["d_ids"][i] for i in picks]
        scores = ([row["scores"][i] for i in picks] if self.has_scores
                  else [None] * len(picks))
        return row["query"], row["q_id"], docs, d_ids, scores


class MsMarcoKDDataset(KnowledgeDistillDataset):
    """MS MARCO KD: a {qid: {doc_id, score}} score dict joined with corpus
    and query text (reference dataset.py:287-326), with the latin1 -> utf-8
    mojibake repair. Zero egress: the corpus and queries must be given (the
    reference downloads BEIR msmarco when they are absent)."""

    @staticmethod
    def transform_str(s: str) -> str:
        """Text that was utf-8 decoded as latin1, decoded right; any other
        text as it is."""
        try:
            return s.encode("latin1").decode("utf-8")
        except (UnicodeEncodeError, UnicodeDecodeError):
            return s

    def __init__(self, score_dic_path, corpus=None, queries=None, sample_num=2, **kw):
        import json

        if corpus is None or queries is None:
            raise ValueError(
                "MsMarcoKDDataset needs a local corpus and queries (zero egress; "
                "the reference downloads BEIR msmarco here)")
        with open(score_dic_path) as f:
            score_dic = json.load(f)
        # each referenced doc repaired once (the reference transforms the
        # corpus up front, dataset.py:300-304)
        fixed: Dict[str, str] = {}

        def doc_text(d):
            t = fixed.get(d)
            if t is None:
                raw = corpus[d]["text"] if isinstance(corpus[d], dict) else corpus[d]
                t = fixed[d] = self.transform_str(raw)
            return t

        rows = [{"query": queries[q_id], "docs": [doc_text(d) for d in entry["doc_id"]],
                 "scores": entry["score"]} for q_id, entry in score_dic.items()]
        super().__init__(rows, sample_num=sample_num, **kw)


class PosNegsDataset:
    """{query, pos, negs} rows -> one item per full chunk of `sample_num`
    negatives (remainder dropped; reference dataset.py:329-358)."""

    def __init__(self, data, sample_num: int = 3, **_):
        assert sample_num >= 1
        self.items: List[Tuple[str, str, List[str]]] = []
        for row in data:
            negs = row.get("negs", []) or []
            for i in range(0, len(negs) - sample_num + 1, sample_num):
                self.items.append((row["query"], row["pos"], list(negs[i: i + sample_num])))
        logger.info("PosNegsDataset: %d items", len(self.items))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int):
        return self.items[idx]


class BEIRCorpusDataset:
    """BEIR corpus dict -> (doc_id, "title text") in sorted-id order; empty
    documents are dropped (reference dataset.py:43-64)."""

    def __init__(self, corpus: Dict[str, Dict[str, str]]):
        self.items: List[Tuple[str, str]] = []
        for key in sorted(corpus.keys()):
            doc = corpus[key]
            text = (doc.get("title", "") + " " + doc.get("text", "")).strip()
            if text:
                self.items.append((key, text))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int):
        return self.items[idx]


class KeyValueDataset:
    """Plain dict -> (key, value) in sorted-key order (dataset.py:43-58)."""

    def __init__(self, data: Dict):
        self.keys = sorted(data.keys())
        self.data = data

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, idx: int):
        k = self.keys[idx]
        return k, self.data[k]


class MiraclCorpusDataset:
    """MIRACL corpus rows {docid, title, text} -> (docid, "title text"),
    optionally transformed (reference dataset.py:101-121)."""

    def __init__(self, corpus, transform_lambda: Optional[Callable[[str], str]] = None):
        self.corpus = corpus
        self.transform = transform_lambda

    def __len__(self):
        return len(self.corpus)

    def __getitem__(self, idx: int):
        row = self.corpus[idx]
        text = row["title"] + " " + row["text"]
        if self.transform is not None:
            text = self.transform(text)
        return row["docid"], text


class MiraclTrainingDataset:
    """MIRACL train rows -> one posnegs row per positive passage, the
    negatives shared by the query's rows (reference dataset.py:361-386)."""

    def __init__(self, rows=None, dataset=None):
        rows = rows if rows is not None else dataset
        if rows is None:
            raise ValueError("MiraclTrainingDataset needs local rows (zero egress)")
        self.rows = rows
        self.index: List[Tuple[int, int]] = []
        self.negs: List[List[str]] = []
        for i, row in enumerate(rows):
            for j in range(len(row["positive_passages"])):
                self.index.append((i, j))
            self.negs.append([n["text"] for n in row["negative_passages"]])

    def __len__(self):
        return len(self.index)

    def __getitem__(self, idx: int):
        i, j = self.index[idx]
        row = self.rows[i]
        return {"query": row["query"], "pos": row["positive_passages"][j]["text"],
                "negs": self.negs[i]}


class HostShardDataset:
    """Static modulo shard of a dataset across processes: item i belongs to
    rank `i % world_size` (the reference's DDPDatasetWithRank,
    dataset.py:124-148)."""

    def __init__(self, inner, rank: int, world_size: int, drop: bool = False,
                 shuffle: bool = False, seed: Optional[int] = None):
        n = len(inner)
        if drop:
            n -= n % world_size
        self.inner = inner
        self.idxs = list(range(rank, n, world_size))
        if shuffle:
            rng = np.random.default_rng(rank if seed is None else seed)
            rng.shuffle(self.idxs)

    def __len__(self):
        return len(self.idxs)

    def __getitem__(self, idx: int):
        return self.inner[self.idxs[idx]]


class CombinedDataset:
    """Several datasets addressed by (dataset_idx, item_idx) pairs; batches
    are drawn wholly from one dataset via CombinedRandomSampler
    (reference dataset.py:425-444)."""

    def __init__(self, datasets: List):
        self.datasets = datasets

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        ds_idx, item_idx = idx
        return self.datasets[ds_idx][item_idx]


class CombinedRandomSampler:
    """Yields batches of (dataset_idx, item_idx) pairs: each batch comes from
    ONE dataset; the dataset visiting order is shuffled with a fixed seed so
    every process agrees on it (reference dataset.py:389-422)."""

    def __init__(self, datasets: List, batch_size: int, seed: int = 0,
                 drop_last: bool = True):
        self.datasets = datasets
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def _batches_per_dataset(self, n: int) -> int:
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __len__(self):
        return sum(self._batches_per_dataset(len(d)) for d in self.datasets)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self._epoch)
        per_ds_batches: List[List[List[Tuple[int, int]]]] = []
        visiting: List[int] = []
        for ds_idx, ds in enumerate(self.datasets):
            perm = rng.permutation(len(ds))
            nb = self._batches_per_dataset(len(ds))
            per_ds_batches.append([
                [(ds_idx, int(j)) for j in perm[b * self.batch_size: (b + 1) * self.batch_size]]
                for b in range(nb)
            ])
            visiting.extend([ds_idx] * nb)
        rng.shuffle(visiting)
        cursors = [0] * len(self.datasets)
        for ds_idx in visiting:
            yield per_ds_batches[ds_idx][cursors[ds_idx]]
            cursors[ds_idx] += 1


DATASET_CLS_MAP = {
    "kd": KnowledgeDistillDataset,
    "posnegs": PosNegsDataset,
    "kd-ids": KnowledgeDistillIdsDataset,
}


def load_dataset(
    path: str,
    cls: str,
    swap_times=0,
    sample_num_one_query: int = 2,
    first_rank_thresh: int = 10000,
    score_scale: float = 1.0,
    shuffle_seed: int = 0,
):
    """Load one HF save_to_disk dir into the dataset class for `cls`
    (reference dataset.py:454-469)."""
    import datasets as hfds

    rows = hfds.Dataset.load_from_disk(path)
    logger.info("load dataset from %s (%s): %d rows", path, cls, len(rows))
    return DATASET_CLS_MAP[cls](
        rows,
        sample_num=sample_num_one_query,
        swap_times=swap_times,
        first_rank_thresh=first_rank_thresh,
        score_scale=score_scale,
        shuffle_seed=shuffle_seed,
    )


def load_datasets(
    path,
    cls: str,
    swap_times=0,
    sample_num_one_query: int = 2,
    first_rank_thresh: int = 10000,
    score_scale: float = 1.0,
    rank: int = 0,
    world_size: int = 1,
    shuffle_seed: int = 0,
):
    """Load every dataset dir under `path` (or a list of such roots), shard
    each across processes, and combine (reference dataset.py:472-523). One
    process (rank 0 of 1) keeps everything; more shard with drop+shuffle like
    the reference's world_size != 1 branch."""
    roots = [path] if isinstance(path, str) else list(path)
    parts = []
    for root in roots:
        for name in sorted(os.listdir(root)):
            parts.append(load_dataset(
                os.path.join(root, name), cls, swap_times, sample_num_one_query,
                first_rank_thresh, score_scale, shuffle_seed=shuffle_seed,
            ))
    sharded = [
        HostShardDataset(d, rank, world_size, drop=world_size != 1, shuffle=world_size != 1)
        for d in parts
    ]
    combined = CombinedDataset(sharded)
    logger.info("combined %d datasets: %d total items", len(parts), len(combined))
    return combined

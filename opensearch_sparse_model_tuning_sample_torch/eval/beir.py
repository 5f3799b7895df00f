"""BEIR evaluation harness: ingest -> search -> metrics, on the device.

The port of the JAX package's `eval/beir.py` (reference
evaluate_beir.py:139-226, ingest.py:23-117, search.py:13-104): `ingest`
encodes the corpus into a SparseIndex, `search` encodes queries
(inference-free by default) and runs the on-device top-k; the FLOPS
statistic ⟨avg q-activations, avg d-activations⟩, q_length and d_length are
kept exactly (search.py:82-93).

Multi-process (rank, world_size): every rank ingests its corpus stripe, the
activation counts are reduced through files in the shared out_dir, every
rank saves its shard index, and rank 0 merges the shards and searches
(reference: all ranks ingest, rank 0 searches). The barrier is the
filesystem, with a heartbeat per rank so a dead peer fails the waiters fast:
no collective, so two ranks may share one card.

Data loading is offline-first: BEIR-format local dirs (corpus.jsonl /
queries.jsonl / qrels/<split>.tsv), HF `save_to_disk` datasets, or the
deterministic synthetic tasks.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import distributed
from ..data.datasets import BEIRCorpusDataset, HostShardDataset, KeyValueDataset
from ..core.mesh import make_mesh
from ..index.engine import IndexConfig, SparseIndex
from ..models.sparse_encoder import SparseEncoderModel, get_batch_encoder
from ..utils import tracing
from . import trec_eval
from .metrics_sink import emit_metrics

logger = logging.getLogger(__name__)

Corpus = Dict[str, Dict[str, str]]
Queries = Dict[str, str]
Qrels = Dict[str, Dict[str, int]]

# ---------------------------------------------------------------------------
# Data loading (offline-first)
# ---------------------------------------------------------------------------


def load_beir_dir(path: str, split: str = "test") -> Tuple[Corpus, Queries, Qrels]:
    """Standard BEIR zip layout: corpus.jsonl, queries.jsonl, qrels/<split>.tsv."""
    corpus: Corpus = {}
    with open(os.path.join(path, "corpus.jsonl"), encoding="utf-8") as f:
        for line in f:
            r = json.loads(line)
            corpus[str(r["_id"])] = {
                "title": r.get("title", ""),
                "text": r.get("text", ""),
            }
    queries: Queries = {}
    with open(os.path.join(path, "queries.jsonl"), encoding="utf-8") as f:
        for line in f:
            r = json.loads(line)
            queries[str(r["_id"])] = r["text"]
    qrels: Qrels = {}
    with open(os.path.join(path, "qrels", f"{split}.tsv"), encoding="utf-8") as f:
        reader = csv.reader(f, delimiter="\t")
        def add(row):
            qid, did, score = str(row[0]), str(row[1]), int(row[2])
            qrels.setdefault(qid, {})[did] = score

        first = next(reader, None)  # empty qrels -> no judgments, not a crash
        if first is not None:
            # sniff the header: some BEIR-format exports omit it — blindly
            # consuming a headerless file's first row would silently drop
            # one judgment
            try:
                add(first)
            except (ValueError, IndexError):
                pass  # a real header row
        for row in reader:
            add(row)
    queries = {q: t for q, t in queries.items() if q in qrels}
    return corpus, queries, qrels


def load_beir_hf_disk(path: str) -> Tuple[Corpus, Queries, Qrels]:
    """HF `save_to_disk` dir with corpus/queries/qrels sub-datasets."""
    import datasets as hfds

    ds_c = hfds.Dataset.load_from_disk(os.path.join(path, "corpus"))
    ds_q = hfds.Dataset.load_from_disk(os.path.join(path, "queries"))
    ds_r = hfds.Dataset.load_from_disk(os.path.join(path, "qrels"))
    corpus = {
        str(r["_id"]): {"title": r.get("title", ""), "text": r["text"]} for r in ds_c
    }
    queries = {str(r["_id"]): r["text"] for r in ds_q}
    qrels: Qrels = {}
    for r in ds_r:
        qrels.setdefault(str(r["query-id"]), {})[str(r["corpus-id"])] = int(
            r.get("score", 1)
        )
    queries = {q: t for q, t in queries.items() if q in qrels}
    return corpus, queries, qrels


def load_dataset_auto(root: str, name: str, split: str = "test"):
    path = os.path.join(root, name)
    if os.path.exists(os.path.join(path, "corpus.jsonl")):
        return load_beir_dir(path, split)
    if os.path.exists(os.path.join(path, "corpus")):
        return load_beir_hf_disk(path)
    raise FileNotFoundError(f"no BEIR data at {path} (need corpus.jsonl or HF dirs)")


def synthetic_beir(
    n_docs: int = 200, n_queries: int = 20, seed: int = 0,
    query_seed: Optional[int] = None,
) -> Tuple[Corpus, Queries, Qrels]:
    """Deterministic synthetic retrieval task: each query names the topic
    words of its relevant docs, so a working pipeline scores near-perfect
    NDCG and a broken one doesn't.

    `query_seed` re-seeds query generation only (same corpus, disjoint
    query sets -> train/test splits without contamination)."""
    rng = np.random.default_rng(seed)
    vocab = [
        "alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
        "hotel", "india", "juliet", "kilo", "lima", "mike", "november",
        "oscar", "papa", "quebec", "romeo", "sierra", "tango",
    ]
    corpus: Corpus = {}
    topics = []
    doc_words = []
    for i in range(n_docs):
        topic = list(rng.choice(vocab, size=3, replace=False))
        topics.append(topic)
        filler = list(rng.choice(vocab, size=4, replace=True))
        words = topic * 3 + filler
        doc_words.append(set(words))
        corpus[f"d{i}"] = {"title": f"about {topic[0]}", "text": " ".join(words)}
    if query_seed is not None:
        rng = np.random.default_rng(query_seed)
    queries: Queries = {}
    qrels: Qrels = {}
    for qi in range(n_queries):
        di = int(rng.integers(0, n_docs))
        q_terms = set(topics[di])
        queries[f"q{qi}"] = " ".join(topics[di])
        # ground truth by containment: the source doc is rel 2; any other doc
        # containing the whole query triple is rel 1 (rare by construction)
        rel = {f"d{di}": 2}
        for dj in range(n_docs):
            if dj != di and q_terms <= doc_words[dj]:
                rel[f"d{dj}"] = 1
        qrels[f"q{qi}"] = rel
    return corpus, queries, qrels


def _rich_vocab(n_vocab: int) -> List[str]:
    """Real whole-token words for the rich synthetic task, drawn from the
    shipped idf asset (assets/idf.npz) so every word is exactly one WordPiece
    token; falls back to deterministic CV-syllable pseudo-words."""
    for cand in (
        os.path.join(os.getcwd(), "assets", "idf.npz"),
        os.path.join(os.path.dirname(__file__), "..", "..", "assets", "idf.npz"),
    ):
        if os.path.exists(cand):
            blob = np.load(cand, allow_pickle=False)
            toks = [str(t) for t in blob["tokens"]]
            words = [t for t in toks if t.isalpha() and 4 <= len(t) <= 10]
            if len(words) >= n_vocab + 200:
                # skip the first (most common) words; keep mid-frequency ones
                return words[200 : 200 + n_vocab]
            break
    # aperiodic CV-syllable generator: i is decomposed base-75 per syllable
    # (15 consonants x 5 vowels), so 3 syllables give 75^3 = 421,875 distinct
    # words — a plain modular form is periodic and capped at ~1,125, which
    # loops forever for the default n_vocab=2000
    cons, vow = "bcdfgklmnprstvz", "aeiou"
    words = []
    for i in range(n_vocab):
        w, x = "", i
        for _ in range(3):
            x, syl = divmod(x, 75)
            w += cons[syl % 15] + vow[syl // 15]
        words.append(w)
    return words


def synthetic_beir_rich(
    n_docs: int = 20000,
    n_queries: int = 300,
    seed: int = 0,
    query_seed: Optional[int] = None,
    n_vocab: int = 2000,
) -> Tuple[Corpus, Queries, Qrels]:
    """Scaled synthetic retrieval benchmark over a real-word vocabulary.

    Docs mix 4 uniformly-sampled topic words (repeated, so each is rare
    corpus-wide) with 24-48 zipf-sampled common fillers; a query names 3 of
    one doc's topic words plus one zipf-common noise word that matches
    thousands of docs. Getting the noise term down-weighted relative to the
    topic terms is exactly what the reference recipes train
    (reference configs/config_infonce.yaml), so NDCG here responds to
    learned term weighting, not just lexical overlap.
    """
    rng = np.random.default_rng(seed)
    vocab = np.asarray(_rich_vocab(n_vocab))
    V = len(vocab)
    zipf_p = 1.0 / np.arange(2, V + 2)
    zipf_p /= zipf_p.sum()

    corpus: Corpus = {}
    topics = np.empty((n_docs, 4), dtype=np.int64)
    doc_topics: List[set] = []
    for i in range(n_docs):
        t = rng.choice(V, size=4, replace=False)  # uniform -> rare words
        topics[i] = t
        n_fill = int(rng.integers(24, 49))
        fill = rng.choice(V, size=n_fill, p=zipf_p)
        words = np.concatenate([np.repeat(t, 3), fill])
        rng.shuffle(words)
        doc_topics.append(set(int(x) for x in t) | set(int(x) for x in fill))
        corpus[f"d{i}"] = {
            "title": " ".join(vocab[t[:2]]),
            "text": " ".join(vocab[words]),
        }

    if query_seed is not None:
        rng = np.random.default_rng(query_seed)
    queries: Queries = {}
    qrels: Qrels = {}
    src = rng.choice(n_docs, size=n_queries, replace=False)
    for qi, di in enumerate(src):
        q_terms = rng.choice(topics[di], size=3, replace=False)
        noise = int(rng.choice(min(50, V), size=1)[0])  # zipf-head word
        queries[f"q{qi}"] = " ".join(vocab[q_terms]) + " " + str(vocab[noise])
        qs = set(int(t) for t in q_terms)
        rel = {f"d{di}": 2}
        for dj in range(n_docs):
            if dj != di and qs <= doc_topics[dj]:
                rel[f"d{dj}"] = 1
        qrels[f"q{qi}"] = rel
    return corpus, queries, qrels


# Named synthetic presets; split only re-seeds query generation (shared
# corpus, disjoint train/test query sets — the BEIR split layout).
_SPLIT_QSEED = {"train": 101, "test": 202, "dev": 303}


def load_synthetic(name: str, split: str = "test"):
    qseed = _SPLIT_QSEED.get(split, 202)
    if name == "synthetic":
        return synthetic_beir(query_seed=qseed)
    if name == "synthetic-nano":
        return synthetic_beir_rich(
            n_docs=2000, n_queries=50, query_seed=qseed, n_vocab=1000
        )
    if name == "synthetic-rich" or name.startswith("synthetic-rich-"):
        n_docs, n_queries = 20000, 300
        if name.startswith("synthetic-rich-"):
            spec = name[len("synthetic-rich-"):]
            n_docs, n_queries = (int(x) for x in spec.split("x"))
        if split == "train":
            # a from-scratch backbone only learns the general doc->tokens map
            # with broad corpus coverage (the reference fine-tunes a
            # PRETRAINED model from ~300 scifact rows; random init cannot)
            n_queries = max(n_queries, min(n_docs // 5, 4000))
        if n_queries > n_docs:
            # each query is sourced from a distinct doc (replace=False)
            raise ValueError(
                f"{name!r}: n_queries={n_queries} cannot exceed "
                f"n_docs={n_docs} (queries are sampled from distinct docs)"
            )
        return synthetic_beir_rich(
            n_docs=n_docs, n_queries=n_queries, query_seed=qseed
        )
    raise KeyError(f"unknown synthetic dataset {name!r}")


def resolve_dataset(name: str, beir_dir: str, split: str = "test"):
    """Dataset resolution shared by the CLIs: built-in synthetic names or a
    local BEIR-format dir (zero-egress stand-in for the reference's HF-hub
    loading, evaluate_beir.py:55-90)."""
    if name.startswith("synthetic"):
        return load_synthetic(name, split)
    return load_dataset_auto(beir_dir, name, split=split)


# ---------------------------------------------------------------------------
# Ingest / search (reference ingest.py / search.py equivalents)
# ---------------------------------------------------------------------------


def _count_part_path(out_dir: str, index_name: str, rank: int, world_size: int) -> str:
    return os.path.join(out_dir, f"{index_name}.count.rank{rank}of{world_size}.npz")


class _Liveness:
    """Fail-fast rank-death detection for the filesystem ingest barrier.

    Each rank touches a heartbeat file while it works (encode loop) and
    while it waits (barrier polls). A peer whose heartbeat file exists but
    has gone stale past `grace` seconds started and then stopped beating:
    presumed dead, and the waiter raises at once instead of hanging until
    the barrier timeout. A peer with no heartbeat yet may simply not have
    launched, so that case keeps the full timeout."""

    def __init__(self, out_dir: str, index_name: str, rank: int, world_size: int,
                 grace: float):
        self.paths = [os.path.join(out_dir, f"{index_name}.hb.rank{r}of{world_size}")
                      for r in range(world_size)]
        self.rank = rank
        self.grace = grace
        self._last = 0.0

    def beat(self, force: bool = False) -> None:
        now = time.time()
        if force or now - self._last >= 2.0:
            with open(self.paths[self.rank], "w"):
                pass
            self._last = now

    def check(self, r: int) -> None:
        """Raise if rank r's heartbeat exists but is stale beyond grace."""
        if not self.grace or r == self.rank:
            return
        try:
            age = time.time() - os.path.getmtime(self.paths[r])
        except OSError:
            return  # never started: the timeout decides
        if age > self.grace:
            raise RuntimeError(
                f"ingest barrier: rank {r} heartbeat is {age:.0f}s stale "
                f"(grace {self.grace:.0f}s) — presumed dead; failing fast "
                f"instead of waiting out the barrier timeout")

    def clear_own(self) -> None:
        try:
            os.remove(self.paths[self.rank])
        except FileNotFoundError:
            pass


@contextmanager
def _beating(liveness: _Liveness, period: float = 2.0):
    """Keep `liveness` beating from a thread across a long host operation
    (index save or merge), so peers do not take a busy rank for a dead one."""
    stop = threading.Event()

    def run():
        while not stop.wait(period):
            liveness.beat(force=True)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        yield
    finally:
        stop.set()
        t.join()


def _await(pred, what: str, timeout: float, liveness: Optional[_Liveness] = None,
           writer_rank: int = 0) -> None:
    """Poll `pred()` every 0.2 s with a heartbeat and the writer's liveness
    check; TimeoutError naming `what` at the deadline. Every filesystem
    barrier wait goes through here."""
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise TimeoutError(f"barrier: {what}")
        if liveness is not None:
            liveness.beat()
            liveness.check(writer_rank)
        time.sleep(0.2)


def _await_fresh(path: str, t_after: float, timeout: float,
                 liveness: Optional[_Liveness] = None, writer_rank: int = 0) -> None:
    """Poll until `path` exists with mtime >= t_after (the shared out_dir's
    clock)."""
    _await(lambda: os.path.exists(path) and os.path.getmtime(path) >= t_after,
           f"no fresh {path}", timeout, liveness, writer_rank)


def _reduce_counts(out_dir: str, index_name: str, rank: int, world_size: int,
                   count_tensor: np.ndarray, n_docs: int, timeout: float,
                   liveness: Optional[_Liveness] = None):
    """Sum the ranks' activation counts through the shared out_dir (atomic
    tmp + rename writes; every rank polls for all parts: this is also the
    ingest barrier, reference ingest.py:108-117 + wait_for_everyone).

    Round over round (repeated ingests into one out_dir/index_name): rank 0
    deletes every part before it writes `{index}.corpus.npy`, and the other
    ranks leave only when they see a stat newer than their own part, so
    round N+1's parts are written only after round N's were removed. Each
    rank also clears its own part at entry (a crashed round's leftovers).
    Returns (total, total_docs, part_write_time)."""
    part = _count_part_path(out_dir, index_name, rank, world_size)
    tmp = part + f".tmp{os.getpid()}.npz"  # np.savez appends .npz otherwise
    np.savez(tmp, count=count_tensor, n_docs=np.int64(n_docs))
    os.replace(tmp, part)
    t_written = os.path.getmtime(part)
    total = np.zeros_like(count_tensor)
    total_docs = 0
    deadline = time.time() + timeout
    for r in range(world_size):
        p = _count_part_path(out_dir, index_name, r, world_size)
        _await(lambda: os.path.exists(p), f"ingest: rank {r} never wrote {p}",
               deadline - time.time(), liveness, r)
        blob = np.load(p)
        total += blob["count"]
        total_docs += int(blob["n_docs"])
    # this rank has read every part: rank 0 deletes the parts only after
    # every rank says so, or a slow rank would wait for a deleted part
    open(part + ".seen", "w").close()
    return total, total_docs, t_written


def ingest(
    dataset,  # sequence of (doc_id, text)
    model: SparseEncoderModel,
    out_dir: str,
    index_name: str,
    max_length: int = 512,
    batch_size: int = 50,
    index_cfg: Optional[IndexConfig] = None,
    mesh=None,
    doc_inf_free: bool = False,
    rank: int = 0,
    world_size: int = 1,
    barrier_timeout: float = 3600.0,
    dead_rank_grace: float = 300.0,
) -> SparseIndex:
    """Encode a corpus and build the index on the model's device, or
    sharded over `mesh` (`core/mesh.py`) when one is given; write the
    corpus activation statistic `{index_name}.corpus.npy` under out_dir.

    With world_size > 1 each rank encodes its stripe of the corpus (item i
    goes to rank i % world_size, the reference's DDPDatasetWithRank, doc ids
    the global ones, so shard indexes merge by concatenation:
    `SparseIndex.merge_saved`), and the ranks' activation counts are summed
    through out_dir before the statistic is written, so the FLOPS statistic
    is the whole corpus's. A peer whose heartbeat goes stale past
    `dead_rank_grace` seconds fails the barrier at once (0 turns that off;
    it must exceed the longest gap between beats: one encode chunk or the
    finalize)."""
    os.makedirs(out_dir, exist_ok=True)
    liveness = None
    if world_size > 1:
        liveness = _Liveness(out_dir, index_name, rank, world_size, dead_rank_grace)
        liveness.beat(force=True)
        # this rank's count part from an earlier ingest into the same out_dir
        # would satisfy the existence barrier with old counts: clear it before
        # encoding, before any rank can be polling
        stale = _count_part_path(out_dir, index_name, rank, world_size)
        for f in (stale, stale + ".seen"):
            if os.path.exists(f):
                os.remove(f)
        dataset = HostShardDataset(dataset, rank, world_size)
    # its own count state, apart from the search encoder's, scoped by rank:
    # ranks run in one process in the threaded tests
    encoder = get_batch_encoder(model, max_length=max_length, do_count=True,
                                scope=("ingest", rank, world_size))
    index = SparseIndex(model.vocab_size, index_cfg, **_placement(mesh, model.device))
    t0 = time.time()
    n = len(dataset)
    if index.cfg.engine != "dense" and not doc_inf_free:
        # chunks of batch_size x 8 docs through the on-device top-k path, each
        # chunk tokenized once and sorted by length, so that each batch runs
        # at the length its own docs need (a multiple of 64), not at the
        # chunk's longest doc; its rows come back in corpus order. Chunk j
        # is queued on the device before chunk j-1 is resolved and added.
        # On a CUDA card neither the copy in nor the copy out syncs the
        # stream, and the resolve waits only for chunk j-1's own event, so
        # the host adds j-1, tokenizes j+1 and launches it while the card
        # runs chunk j
        CH = batch_size * 8
        pending = None  # (ids, n_valid, handle)

        def flush(entry):
            e_ids, nv, handle = entry
            tok_idx, ws = encoder.resolve_chunk_sparse(handle, nv)
            index.add_topk(e_ids, tok_idx, ws)

        for start in range(0, n, CH):
            if liveness is not None:
                liveness.beat()
            with tracing.span("data.tokenize"):
                rows = [dataset[i] for i in range(start, min(start + CH, n))]
            handle, nv = encoder.encode_chunk_sparse_async(
                [r[1] for r in rows], l_max=index.cfg.l_max, rows=batch_size
            )
            if pending is not None:
                flush(pending)
            pending = ([r[0] for r in rows], nv, handle)
        if pending is not None:
            flush(pending)
    else:
        for start in range(0, n, batch_size):
            if liveness is not None:
                liveness.beat()
            with tracing.span("data.tokenize"):
                rows = [dataset[i] for i in range(start, min(start + batch_size, n))]
            # doc_inf_free=True gives an idf-weighted lexical index (a
            # BM25-ish baseline and the test oracle)
            reps = encoder.encode_batch([r[1] for r in rows], inf_free=doc_inf_free)
            index.add([r[0] for r in rows], reps)
    index.finalize()
    with tracing.span("index.stat"):
        # the corpus statistic counts every rep>0 activation of the FULL encoder
        # output (reference SparseEncoder, sparse_encoders.py:178-179), not the
        # top-l_max rows the index stores
        corpus_stat = os.path.join(out_dir, f"{index_name}.corpus.npy")
        full_counts = encoder.count_tensor
        if world_size > 1:
            liveness.beat(force=True)  # finalize may have been a long gap
            counts, total_docs, t_part = _reduce_counts(
                out_dir, index_name, rank, world_size, full_counts, index.n_docs,
                barrier_timeout, liveness)
            if rank == 0:  # one writer (reference: the main process saves the stat)
                # every rank has read the parts: remove them, then publish the
                # stat; the others leave only on seeing this fresh stat, so the
                # next round's barrier starts clean
                deadline = time.time() + barrier_timeout
                for r in range(world_size):
                    m = _count_part_path(out_dir, index_name, r, world_size) + ".seen"
                    _await(lambda: os.path.exists(m), f"ingest: rank {r} never confirmed {m}",
                           deadline - time.time(), liveness, r)
                for r in range(world_size):
                    base = _count_part_path(out_dir, index_name, r, world_size)
                    for f in (base, base + ".seen"):
                        try:
                            os.remove(f)
                        except FileNotFoundError:
                            pass
                tmp = corpus_stat + f".tmp{os.getpid()}.npy"
                np.save(tmp, counts.astype(np.float64) / max(total_docs, 1))
                os.replace(tmp, corpus_stat)
            else:
                # the departure barrier: the stat this rank reads is this round's
                # (reference gates search behind wait_for_everyone,
                # evaluate_beir.py:196)
                _await_fresh(corpus_stat, t_part, barrier_timeout, liveness, writer_rank=0)
            liveness.clear_own()  # a departed rank is not a dead rank
        else:
            np.save(corpus_stat, full_counts.astype(np.float64) / max(index.n_docs, 1))
    dt = time.time() - t0
    logger.info("ingested %d docs into %s in %.1fs (%.1f docs/s)", n, index_name,
                dt, n / max(dt, 1e-9))
    return index


def search(
    queries: Queries,
    model: SparseEncoderModel,
    index: SparseIndex,
    out_dir: str,
    index_name: str,
    max_length: int = 512,
    batch_size: int = 50,
    result_size: int = 15,
    inf_free: bool = True,
    query_prune: float = 0.0,
    use_two_phase: bool = False,
    return_text: bool = False,
    corpus_texts: Optional[Dict[str, str]] = None,
    delete: bool = False,
) -> Dict:
    """Encode queries, top-k search, FLOPS stats — reference search.py:13-104.
    On the inverted engine also the certificate tally: the share of queries
    certified exact and the share that re-ran (escalated). With
    `return_text` and `corpus_texts` the result also holds each query's hit
    texts (`run_texts`). `delete`: drop the index after the search
    (reference search.py:95-97 `indices.delete`: frees the card's memory
    between datasets)."""
    qd = KeyValueDataset(queries)
    encoder = get_batch_encoder(model, max_length=max_length, do_count=True)
    run_res: Dict[str, Dict[str, float]] = {}
    n_cert = n_esc = n_flagged = 0
    t0 = time.time()
    n = len(qd)
    # chunks of the whole batches that fit in 4096 rows, each chunk one
    # search call over its queries' reps
    chunk_rows = max(4096 // batch_size, 1) * batch_size
    for cstart in range(0, n, chunk_rows):
        rows = [qd[i] for i in range(cstart, min(cstart + chunk_rows, n))]
        reps = encoder.encode_batch_device([r[1] for r in rows], inf_free=inf_free,
                                           rows=batch_size)
        hits = index.search(reps, k=result_size, query_prune=query_prune,
                            two_phase=use_two_phase,
                            full_forward=True if not inf_free else None)
        for (qid, _), h in zip(rows, hits):
            run_res[qid] = h
        cert = index.last_certified
        if cert is not None:
            n_cert += int(cert.sum())
            if index.last_escalated is not None:
                n_esc += int(index.last_escalated.sum())
            n_flagged += len(rows)
    qps = n / max(time.time() - t0, 1e-9)

    # drop self-hits (mining on train splits, reference search.py:78-80)
    for qid, doc_dict in run_res.items():
        doc_dict.pop(qid, None)

    count_q = encoder.count_tensor.astype(np.float64) / max(n, 1)
    count_d = np.load(os.path.join(out_dir, f"{index_name}.corpus.npy"))
    flops = float(count_q @ count_d)
    q_length = float(count_q.sum())
    d_length = float(count_d.sum())
    logger.info("Index_name: %s, flops: %s, d_length:%s, q_length:%s (%.1f q/s)",
                index_name, flops, d_length, q_length, qps)
    if delete:
        index.delete()
    out = {"run_res": run_res, "flops": flops, "q_length": q_length,
           "d_length": d_length, "qps": qps}
    if n_flagged:
        out["certified_frac"] = n_cert / n_flagged
        out["escalated_frac"] = n_esc / n_flagged
    if return_text and corpus_texts is not None:
        out["run_texts"] = {qid: [corpus_texts[d] for d in docs]
                            for qid, docs in run_res.items()}
    return out


def _placement(mesh, device) -> dict:
    """SparseIndex's placement keywords: the mesh when there is one (the
    index then lives on its first device), else the device."""
    return {"mesh": mesh} if mesh is not None else {"device": device}


def save_and_merge_shards(index: SparseIndex, index_dir: str, rank: int, world_size: int,
                          device, mesh=None) -> Optional[SparseIndex]:
    """Every rank saves its stripe as `{index_dir}.shard{rank}of{world}` and
    marks it `.done`; rank 0 waits up to an hour for every marker (failing
    fast on a heartbeat stale for 300 s) and returns the merged index on
    `mesh`, or on `device` without one. Other ranks return None."""
    parent, base = os.path.split(index_dir)
    liveness = _Liveness(parent, f"{base}.shards", rank, world_size, grace=300.0)
    liveness.beat(force=True)
    shard_dir = f"{index_dir}.shard{rank}of{world_size}"
    with _beating(liveness):  # a save can take minutes at scale
        index.save(shard_dir)
    open(os.path.join(shard_dir, ".done"), "w").close()
    if rank != 0:
        liveness.clear_own()
        return None
    shards = [f"{index_dir}.shard{r}of{world_size}" for r in range(world_size)]
    deadline = time.time() + 3600.0
    for r, p in enumerate(shards):
        done = os.path.join(p, ".done")
        _await(lambda: os.path.exists(done), f"shard never finished: {p}",
               deadline - time.time(), liveness, r)
    liveness.clear_own()
    return SparseIndex.merge_saved(shards, **_placement(mesh, device))


# ---------------------------------------------------------------------------
# Harness (reference evaluate_beir.py:139-328)
# ---------------------------------------------------------------------------


def index_cfg_from_args(data_args) -> IndexConfig:
    """IndexConfig from the eval knobs (DataArguments extensions)."""
    return IndexConfig(
        engine=getattr(data_args, "index_engine", "auto"),
        l_max=getattr(data_args, "index_l_max", 256),
        postings_cap=getattr(data_args, "index_postings_cap", 2048),
        query_batch=getattr(data_args, "index_query_batch", 64),
        query_terms=getattr(data_args, "index_query_terms", 16),
        exact_escalate=getattr(data_args, "index_exact_escalate", None),
        inverted_rescore_expand=getattr(data_args, "index_rescore_expand", 16),
        postings_ext_cap=getattr(data_args, "index_postings_ext_cap", 0),
        deep_slots=getattr(data_args, "index_deep_slots", 2),
        shard_by=getattr(data_args, "index_shard_by", "docs"),
        two_phase_mode=getattr(data_args, "index_two_phase_mode", "query"),
        two_phase_ratio=getattr(data_args, "index_two_phase_ratio", 0.4),
    )


def eval_suffix(model_args, data_args) -> str:
    """Result-dir suffix encoding eval knobs (evaluate_beir.py:41-52)."""
    suffix = "_2p" if data_args.use_two_phase else ""
    if data_args.query_prune > 0:
        suffix += f"_{data_args.query_prune}"
    if data_args.eval_max_seq_length != 512:
        suffix += f"_{data_args.eval_max_seq_length}"
    if model_args.prune_ratio is not None:
        suffix += f"_{model_args.prune_ratio}"
    return suffix


def evaluate_datasets(
    datasets: List[str],
    load_fn,
    model: SparseEncoderModel,
    model_args,
    data_args,
    training_args,
    eval_dir: str,
    mesh=None,
    metrics_index: str = "beir_eval",
    step: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
) -> Dict[str, float]:
    """Per dataset: load -> ingest -> search -> NDCG@10; write CSV + avg
    JSON + metrics records. Returns avg_res. The index is sharded over
    `mesh` when one is given, else on the model's device.

    Multi-process (rank/world_size, by default from the process group, else
    from RANK/WORLD_SIZE): every rank ingests its corpus stripe and saves a
    shard index `{name}.index.shard{r}of{w}` with a `.done` marker; rank 0
    merges the shards, searches and writes the metrics (reference: all
    ranks ingest, rank 0 searches, evaluate_beir.py:159-196). Other ranks
    return {}; under such a launch each rank's mesh is its own device
    (the stripes are process-local, and only rank 0 searches)."""
    if rank is None or world_size is None:
        rank, world_size = distributed.rank(), distributed.world_size()
    if world_size > 1:
        mesh = make_mesh(devices=[model.device])
    os.makedirs(eval_dir, exist_ok=True)
    k_values = [int(k) for k in getattr(data_args, "eval_k_values", None) or [1, 10]]
    if 10 not in k_values:  # NDCG@10 is the headline metric everywhere below
        k_values = sorted(k_values + [10])
    result_size = getattr(data_args, "eval_result_size", None) or max(k_values)
    extra_cols = [f"Recall@{k}" for k in k_values if k not in (1, 10)]
    result = {
        "dataset": [], "flops": [], "NDCG@10": [],
        **{c: [] for c in extra_cols},
        "q_length": [], "d_length": [], "qps": [],
        # the certificate tally (inverted engine; None elsewhere)
        "certified_frac": [], "escalated_frac": [],
    }
    for name in datasets:
        corpus, queries, qrels = load_fn(name)
        logger.info("Loaded %s: %d docs, %d queries", name, len(corpus), len(queries))
        index_dir = os.path.join(eval_dir, f"{name.lower()}.index")
        if not data_args.skip_ingest:
            shard_dir = f"{index_dir}.shard{rank}of{world_size}"
            if world_size > 1:
                # clear this rank's stale marker before the ingest barrier:
                # the barrier guarantees every rank has passed this point
                # before rank 0 polls the markers, so a repeat call into the
                # same eval_dir cannot merge a previous round's shard
                try:
                    os.remove(os.path.join(shard_dir, ".done"))
                except FileNotFoundError:
                    pass
            index = ingest(
                BEIRCorpusDataset(corpus), model, eval_dir, name.lower(),
                max_length=data_args.eval_max_seq_length,
                batch_size=training_args.per_device_eval_batch_size,
                index_cfg=index_cfg_from_args(data_args),
                mesh=mesh, rank=rank, world_size=world_size,
            )
            if world_size > 1:
                index = save_and_merge_shards(index, index_dir, rank, world_size, model.device,
                                              mesh)
                if index is None:
                    continue
            # persist like the reference's OpenSearch node does implicitly:
            # a later run with skip_ingest: true reuses it
            index.save(index_dir)
        else:
            if rank != 0:
                continue
            index = SparseIndex.load(index_dir, **_placement(mesh, model.device))
        if not data_args.do_search:
            continue
        res = search(
            queries, model, index, eval_dir, name.lower(),
            max_length=data_args.eval_max_seq_length,
            batch_size=training_args.per_device_eval_batch_size,
            result_size=result_size,
            inf_free=model_args.inf_free,
            query_prune=data_args.query_prune,
            use_two_phase=data_args.use_two_phase,
        )
        ndcg, _map, recall, p = trec_eval.evaluate(qrels, res["run_res"], k_values)
        logger.info("retrieve metrics for %s: %s %s %s %s", name, ndcg, _map, recall, p)
        result["dataset"].append(name)
        result["NDCG@10"].append(ndcg["NDCG@10"])
        for c in extra_cols:
            result[c].append(recall[c])
        for key in ("flops", "q_length", "d_length", "qps"):
            result[key].append(res[key])
        for key in ("certified_frac", "escalated_frac"):
            result[key].append(res.get(key))

    if not data_args.do_search or not result["dataset"]:
        return {}

    avg_res = {
        key: sum(result[key]) / len(result[key])
        for key in ["flops", "q_length", "d_length", "NDCG@10", "qps", *extra_cols]
    }
    cert_vals = [v for v in result["certified_frac"] if v is not None]
    if cert_vals:  # only inverted-engine runs produce the certificate
        avg_res["certified_frac"] = sum(cert_vals) / len(cert_vals)
        esc_vals = [v for v in result["escalated_frac"] if v is not None]
        avg_res["escalated_frac"] = sum(esc_vals) / len(esc_vals)
    tag = f"_step{step}" if step is not None else ""
    cols = ["dataset", "flops", "NDCG@10", *extra_cols, "q_length", "d_length", "qps",
            "certified_frac", "escalated_frac"]
    with open(os.path.join(eval_dir, f"beir_statistics{tag}.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for i in range(len(result["dataset"])):
            w.writerow([result[c][i] for c in cols])
    with open(os.path.join(eval_dir, f"avg_res{tag}.json"), "w") as f:
        json.dump(avg_res, f)

    doc_id = training_args.output_dir + eval_suffix(model_args, data_args) + tag
    ts = time.time()
    emit_metrics({**avg_res, "timestamp": ts, "dataset_number": len(result["dataset"])},
                 metrics_index, doc_id)
    emit_metrics(
        {"records": [{k: result[k][i] for k in result}
                     for i in range(len(result["dataset"]))], "timestamp": ts},
        f"{metrics_index}_records", doc_id,
    )
    return avg_res

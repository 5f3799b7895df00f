"""BEIR evaluation harness: ingest -> search -> metrics, on the device.

The port of the JAX package's `eval/beir.py` for one process on one card
(reference evaluate_beir.py:139-226, ingest.py:23-117, search.py:13-104):
`ingest` encodes the corpus into a SparseIndex, `search` encodes queries
(inference-free by default) and runs the on-device top-k; the FLOPS
statistic ⟨avg q-activations, avg d-activations⟩, q_length and d_length are
kept exactly (search.py:82-93). Multi-process ingest (world_size > 1) is not
ported yet.

Data loading is offline-first: BEIR-format local dirs (corpus.jsonl /
queries.jsonl / qrels/<split>.tsv), HF `save_to_disk` datasets, or the
deterministic synthetic tasks.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.datasets import BEIRCorpusDataset, KeyValueDataset
from ..index.engine import IndexConfig, SparseIndex
from ..models.sparse_encoder import SparseEncoderModel, get_batch_encoder
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


def ingest(
    dataset,  # sequence of (doc_id, text)
    model: SparseEncoderModel,
    out_dir: str,
    index_name: str,
    max_length: int = 512,
    batch_size: int = 50,
    index_cfg: Optional[IndexConfig] = None,
    doc_inf_free: bool = False,
) -> SparseIndex:
    """Encode a corpus and build the index on the model's device; write the
    corpus activation statistic `{index_name}.corpus.npy` under out_dir.
    One process: multi-process ingest is not ported yet (ROADMAP: port
    queue, distribution)."""
    os.makedirs(out_dir, exist_ok=True)
    # its own count state, apart from the search encoder's
    encoder = get_batch_encoder(model, max_length=max_length, do_count=True,
                                scope="ingest")
    index = SparseIndex(model.vocab_size, index_cfg, device=model.device)
    t0 = time.time()
    n = len(dataset)
    if index.cfg.engine != "dense" and not doc_inf_free:
        # chunks of batch_size x 8 docs through the on-device top-k path; the
        # next chunk is queued on the device before the previous one is
        # copied back and added, so host and device overlap
        CH = batch_size * 8
        pending = None  # (ids, n_valid, handle)

        def flush(entry):
            e_ids, nv, handle = entry
            tok_idx, ws = encoder.resolve_chunk_sparse(handle, nv)
            index.add_topk(e_ids, tok_idx, ws)

        for start in range(0, n, CH):
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
            rows = [dataset[i] for i in range(start, min(start + batch_size, n))]
            # doc_inf_free=True gives an idf-weighted lexical index (a
            # BM25-ish baseline and the test oracle)
            reps = encoder.encode_batch([r[1] for r in rows], inf_free=doc_inf_free)
            index.add([r[0] for r in rows], reps)
    index.finalize()
    # the corpus statistic counts every rep>0 activation of the FULL encoder
    # output (reference SparseEncoder, sparse_encoders.py:178-179), not the
    # top-l_max rows the index stores
    np.save(os.path.join(out_dir, f"{index_name}.corpus.npy"),
            encoder.count_tensor.astype(np.float64) / max(index.n_docs, 1))
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
) -> Dict:
    """Encode queries, top-k search, FLOPS stats — reference search.py:13-104."""
    qd = KeyValueDataset(queries)
    encoder = get_batch_encoder(model, max_length=max_length, do_count=True)
    run_res: Dict[str, Dict[str, float]] = {}
    t0 = time.time()
    n = len(qd)
    # chunks of a power-of-two count of batches (~4096 rows), so full chunks
    # need no batch padding; only the tail chunk pays it
    nb_chunk = 1
    while nb_chunk * 2 * batch_size <= 4096:
        nb_chunk *= 2
    chunk_rows = nb_chunk * batch_size
    for cstart in range(0, n, chunk_rows):
        rows = [qd[i] for i in range(cstart, min(cstart + chunk_rows, n))]
        reps, _ = encoder.encode_chunk_device([r[1] for r in rows], inf_free=inf_free,
                                              rows=batch_size)
        hits = index.search(reps, k=result_size, query_prune=query_prune,
                            two_phase=use_two_phase,
                            full_forward=True if not inf_free else None)
        # reps rows beyond len(rows) are chunk padding; zip drops their hits
        for (qid, _), h in zip(rows, hits):
            run_res[qid] = h
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
    return {"run_res": run_res, "flops": flops, "q_length": q_length,
            "d_length": d_length, "qps": qps}


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
    metrics_index: str = "beir_eval",
    step: Optional[str] = None,
) -> Dict[str, float]:
    """Per dataset: load -> ingest -> search -> NDCG@10; write CSV + avg
    JSON + metrics records. Returns avg_res. One process, one device: the
    model's."""
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
    }
    for name in datasets:
        corpus, queries, qrels = load_fn(name)
        logger.info("Loaded %s: %d docs, %d queries", name, len(corpus), len(queries))
        index_dir = os.path.join(eval_dir, f"{name.lower()}.index")
        if not data_args.skip_ingest:
            index = ingest(
                BEIRCorpusDataset(corpus), model, eval_dir, name.lower(),
                max_length=data_args.eval_max_seq_length,
                batch_size=training_args.per_device_eval_batch_size,
                index_cfg=index_cfg_from_args(data_args),
            )
            # persist like the reference's OpenSearch node does implicitly:
            # a later run with skip_ingest: true reuses it
            index.save(index_dir)
        else:
            index = SparseIndex.load(index_dir, device=model.device)
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

    if not data_args.do_search or not result["dataset"]:
        return {}

    avg_res = {
        key: sum(result[key]) / len(result[key])
        for key in ["flops", "q_length", "d_length", "NDCG@10", "qps", *extra_cols]
    }
    tag = f"_step{step}" if step is not None else ""
    cols = ["dataset", "flops", "NDCG@10", *extra_cols, "q_length", "d_length", "qps"]
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

"""The port's `cli.serve` against the JAX package's, over HTTP: both serve
one checkpoint (the JAX package's `tiny` with its head transform at 4·I, so
reps are lexical) and the same saved indexes on port 0, and get the same
requests: `query_tokens`, `query_text` (inference-free and full forward),
`size`, `query_prune`, `_bulk` (`text`, `text_sparse`, mixed), `_refresh`,
bulk -> search -> bulk (`reopen`), two-phase by the body flag and by
`search_pipeline` on an index in each mode, `_encode`, the 400/404 cases, a
16-client burst; and, in process, the micro-batcher's power-of-two padding
and a raw-text bulk run in batches of at most `max_batch` rows.

Compared: status codes, `hits.total`, the `_id` order (ties excepted),
scores within 1e-5 relative (fp32 compute and fp32 index weights on both
sides: the same sums in another order), and no `ext` in either response.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_sparse_model_tuning_sample_tpu.cli import serve as jserve
from opensearch_sparse_model_tuning_sample_tpu.eval.beir import synthetic_beir_rich
from opensearch_sparse_model_tuning_sample_tpu.index.engine import (
    IndexConfig as JIndexConfig,
    SparseIndex as JSparseIndex,
)
from opensearch_sparse_model_tuning_sample_tpu.models import hf_import as jhf
from opensearch_sparse_model_tuning_sample_tpu.models import sparse_encoder as jse
from opensearch_sparse_model_tuning_sample_torch.cli import serve as tserve
from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig, SparseIndex
from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse

torch.set_num_threads(2)

RTOL = 1e-5
INDEX_CFG = dict(engine="sparse", l_max=16, block_docs=32, query_batch=4,
                 weight_dtype="float32")


def _save_indexes(model, root):
    """testidx: 64 docs of 5 random tokens, doc 7 THE doc for "the" (as
    tests/test_serve.py builds it); rq / rd: 60 synthetic docs encoded by the
    model, two-phase in "query" / "doc" mode with small pools."""
    V = model.vocab_size
    rng = np.random.default_rng(0)
    idx = JSparseIndex(V, JIndexConfig(**INDEX_CFG))
    reps = np.zeros((64, V), np.float32)
    for i in range(64):
        reps[i, rng.choice(V, 5, replace=False)] = rng.uniform(0.5, 2.0, 5)
    reps[7, model.tokenizer.vocab["the"]] = 9.0
    idx.add([str(i) for i in range(64)], reps)
    idx.finalize()
    idx.save(str(root / "testidx"))
    corpus, queries, _ = synthetic_beir_rich(n_docs=60, n_queries=12, seed=3, n_vocab=200)
    texts = [d["title"] + " " + d["text"] for d in corpus.values()]
    tok, w = jse.BatchEncoder(model, max_length=64).encode_batch_sparse(texts, l_max=32)
    for name, mode in (("rq", "query"), ("rd", "doc")):
        idx = JSparseIndex(V, JIndexConfig(
            engine="sparse", l_max=32, block_docs=16, query_batch=4, weight_dtype="float32",
            two_phase_mode=mode, two_phase_terms=4, two_phase_expand=1))
        idx.add_topk(list(corpus), np.asarray(tok), np.asarray(w))
        idx.finalize()
        idx.save(str(root / name))
    return list(queries.values()), texts


def _start(serve_mod, state):
    httpd = serve_mod.serve(state, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def servers(tiny_model, tmp_path_factory):
    bert = dict(tiny_model.params["bert"])
    head = dict(bert["mlm_head"])
    head["transform"] = dict(head["transform"],
                             kernel=jnp.eye(tiny_model.cfg.hidden_size) * 4.0)
    bert["mlm_head"] = head
    jax_model = dataclasses.replace(tiny_model, params=dict(tiny_model.params, bert=bert))
    root = tmp_path_factory.mktemp("serve")
    ckpt = str(root / "checkpoint-tiny")
    jhf.save_checkpoint(jax_model, ckpt)
    queries, texts = _save_indexes(jax_model, root)

    jm = jse.build_model(model_name_or_path=ckpt, idf_path="assets/idf.npz",
                         compute_dtype=jnp.float32)
    tm = tse.build_model(model_name_or_path=ckpt, idf_path="assets/idf.npz",
                         compute_dtype=torch.float32, device="cpu")
    names = ("testidx", "rq", "rd")
    jstate = jserve.ServingState(
        jm, {n: JSparseIndex.load(str(root / n)) for n in names}, max_length=32,
        index_cfg=JIndexConfig(**INDEX_CFG), batch_window_ms=50.0, max_batch=16)
    tstate = tserve.ServingState(
        tm, {n: SparseIndex.load(str(root / n), device="cpu") for n in names}, max_length=32,
        index_cfg=IndexConfig(**INDEX_CFG), batch_window_ms=50.0, max_batch=16)
    (jh, jurl), (th, turl) = _start(jserve, jstate), _start(tserve, tstate)
    yield {"jax": jurl, "torch": turl, "tstate": tstate, "queries": queries, "texts": texts}
    jh.shutdown()
    th.shutdown()


def _call(base, method, path, body=None, raw=None):
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _assert_same_hits(got, ref):
    """One search response against the other: total, ids in order up to
    near-ties, scores to RTOL, no exactness extension."""
    assert "ext" not in got and "ext" not in ref
    gh, rh = got["hits"], ref["hits"]
    assert gh["total"] == rh["total"]
    gs = [h["_score"] for h in gh["hits"]]
    rs = [h["_score"] for h in rh["hits"]]
    np.testing.assert_allclose(gs, rs, rtol=RTOL)
    if rs:
        assert gh["max_score"] == pytest.approx(rh["max_score"], rel=RTOL)
    else:
        assert gh["max_score"] is None and rh["max_score"] is None
    for i, (g, r) in enumerate(zip(gh["hits"], rh["hits"])):
        assert g["_index"] == r["_index"]
        if g["_id"] != r["_id"]:  # a swap between near-ties only
            assert any(abs(r["_score"] - s) <= RTOL * abs(s)
                       for j, s in enumerate(rs) if j != i and rh["hits"][j]["_id"] == g["_id"])


def _both(servers, method, path, body=None, raw=None):
    j = _call(servers["jax"], method, path, body, raw)
    t = _call(servers["torch"], method, path, body, raw)
    assert t[0] == j[0], (path, t, j)
    return t, j


def _search(servers, index, spec, path_suffix="", **body):
    (code, got), (_, ref) = _both(servers, "POST", f"/{index}/_search{path_suffix}",
                                  {"query": {"neural_sparse": {"text_sparse": spec}}, **body})
    assert code == 200, got
    _assert_same_hits(got, ref)
    return got


def _bulk_body(docs):
    lines = []
    for index, doc_id, source in docs:
        lines += [{"index": {"_index": index, "_id": doc_id}}, source]
    return ("\n".join(json.dumps(x) for x in lines) + "\n").encode()


def test_info_health_stats(servers):
    (_, got), (_, ref) = _both(servers, "GET", "/")
    assert got["indexes"] == ref["indexes"] == {"testidx": 64, "rq": 60, "rd": 60}
    assert got.keys() == ref.keys()
    (_, got), (_, ref) = _both(servers, "GET", "/_health")
    assert got == ref == {"status": "green"}
    (_, got), (_, ref) = _both(servers, "GET", "/_stats")
    assert got.keys() == ref.keys() and got["search_microbatch"].keys() == ref[
        "search_microbatch"].keys()


@pytest.mark.parametrize("index,tokens,size,prune", [
    ("testidx", {"the": 3.0}, 3, 0.0),
    ("testidx", {"the": 3.0, "of": 1.0, "zebra": 0.5, "qqqqnotaword": 9.0}, 10, 0.0),
    ("rq", {"the": 0.2, "data": 1.5, "model": 1.0, "system": 0.7}, 10, 0.0),
    ("rq", {"the": 0.2, "data": 1.5, "model": 1.0, "system": 0.7}, 100, 0.5),
    ("rd", {"qqqqnotaword": 1.0}, 5, 0.0),
])
def test_query_tokens(servers, index, tokens, size, prune):
    got = _search(servers, index, {"query_tokens": tokens}, size=size, query_prune=prune)
    if index == "testidx" and len(tokens) == 1:
        assert got["hits"]["hits"][0]["_id"] == "7"
        assert got["hits"]["hits"][0]["_score"] == pytest.approx(27.0, rel=1e-6)


@pytest.mark.parametrize("inf_free", [True, False])
@pytest.mark.parametrize("index", ["rq", "rd"])
def test_query_text(servers, index, inf_free):
    n_hits = 0
    for text in servers["queries"][:5]:
        got = _search(servers, index, {"query_text": text, "inf_free": inf_free}, size=7)
        n_hits += got["hits"]["total"]["value"]
    assert n_hits > 10  # lexical reps: the queries retrieve


@pytest.mark.parametrize("index", ["rq", "rd"])
def test_two_phase_by_flag_and_pipeline(servers, index):
    """Two-phase on an index in each mode (pools of k, four phase-1 terms a
    doc in "doc" mode): the body flag and ?search_pipeline= agree across
    the packages and with each other."""
    (code, _), _ = _both(servers, "PUT", "/_search/pipeline/tp", {
        "request_processors": [{"neural_sparse_two_phase_processor": {"tag": "ns"}}]})
    assert code == 200
    texts = servers["texts"]
    tokenize = servers["tstate"].model.tokenizer.tokenize
    specs = [{"query_text": text, "inf_free": True} for text in texts[20:24]]
    for i in range(4):
        # one heavy token of one doc, light tokens of another doc: query-mode
        # phase 1 sees the heavy token only
        light = dict.fromkeys(tokenize(texts[30 + i]), 1.0)
        heavy = next(t for t in tokenize(texts[40 + i]) if t not in light)
        specs.append({"query_tokens": {**light, heavy: 3.0}})
    differs = 0
    for spec in specs:
        flag = _search(servers, index, spec, size=5, two_phase=True)
        piped = _search(servers, index, spec, path_suffix="?search_pipeline=tp", size=5)
        assert flag == dict(piped, took=flag["took"])
        exact = _search(servers, index, spec, size=5)
        differs += [h["_id"] for h in flag["hits"]["hits"]] != [
            h["_id"] for h in exact["hits"]["hits"]]
    assert differs > 0  # phase 1 is approximate here


def test_error_routes(servers):
    (code, _), _ = _both(servers, "POST", "/testidx/_search?search_pipeline=nope",
                         {"query": {"neural_sparse": {"f": {"query_tokens": {"the": 1.0}}}}})
    assert code == 400
    (code, _), _ = _both(servers, "PUT", "/testidx", {})
    assert code == 400
    (code, _), _ = _both(servers, "POST", "/nope/_search", {})
    assert code == 404
    (code, _), _ = _both(servers, "POST", "/nope/_refresh", {})
    assert code == 404
    (code, _), _ = _both(servers, "POST", "/testidx/_search", raw=b'{"query": {}}')
    assert code == 400
    (code, _), _ = _both(servers, "POST", "/testidx/_search", raw=b"not json")
    assert code == 400
    (code, _), _ = _both(servers, "DELETE", "/nope")
    assert code == 404
    (code, _), _ = _both(servers, "GET", "/a/b/c")
    assert code == 404
    (code, _), _ = _both(servers, "POST", "/_bulk", raw=_bulk_body(
        [("testidx", "x", {"text_sparse": {"the": 1.0}}), ("nope", "y", {"text": "a"})]))
    assert code == 400
    (_, got), (_, ref) = _both(servers, "GET", "/")
    assert got["indexes"]["testidx"] == ref["indexes"]["testidx"] == 64  # nothing ingested
    (_, got), _ = _both(servers, "GET", "/_health")
    assert got["status"] == "green"


def test_write_loop_with_reopen(servers):
    """PUT -> _bulk (text_sparse, raw text, mixed) -> _refresh -> search ->
    _bulk more (reopen, no refresh: the search finalizes) -> search sees
    both rounds -> DELETE."""
    (code, got), (_, ref) = _both(servers, "PUT", "/w", {"settings": {"index": {
        "number_of_shards": 12, "l_max": 16, "engine": "sparse", "block_docs": 32,
        "query_batch": 4}}})
    assert code == 200 and got == ref
    texts = servers["texts"]
    first = [("w", f"s{i}", {"text_sparse": {tok: w, "animal": 1.0}})
             for i, (tok, w) in enumerate([("cat", 3.0), ("dog", 2.5), ("fish", 1.5)])]
    first += [("w", f"t{i}", {"text": texts[i]}) for i in range(6)]
    (code, got), (_, ref) = _both(servers, "POST", "/_bulk", raw=_bulk_body(first))
    assert code == 200 and got["errors"] is False and got["items"] == ref["items"]
    (code, got), (_, ref) = _both(servers, "POST", "/w/_refresh")
    assert code == 200 and got == ref
    hit = _search(servers, "w", {"query_tokens": {"cat": 2.0, "animal": 0.1}}, size=3)
    assert hit["hits"]["hits"][0]["_id"] == "s0"
    _search(servers, "w", {"query_text": texts[2], "inf_free": True}, size=4)
    second = [("w", "s9", {"text_sparse": {"cat": 9.0}}), ("w", "t9", {"text": texts[10]})]
    (code, got), (_, ref) = _both(servers, "POST", "/_bulk", raw=_bulk_body(second))
    assert code == 200 and got["items"] == ref["items"]
    hit = _search(servers, "w", {"query_tokens": {"cat": 1.0}}, size=2)
    assert [h["_id"] for h in hit["hits"]["hits"]] == ["s9", "s0"]  # both rounds
    hit = _search(servers, "w", {"query_text": texts[10], "inf_free": False}, size=20)
    ids = {h["_id"] for h in hit["hits"]["hits"]}
    assert "t9" in ids and ids & {f"t{i}" for i in range(6)}
    (_, got), (_, ref) = _both(servers, "GET", "/")
    assert got["indexes"]["w"] == ref["indexes"]["w"] == 11
    (code, _), _ = _both(servers, "DELETE", "/w")
    assert code == 200


def test_encode_route(servers):
    for inf_free in (True, False):
        (code, got), (_, ref) = _both(servers, "POST", "/_encode", {
            "texts": ["the quick brown fox", servers["texts"][0]], "inf_free": inf_free})
        assert code == 200
        for g, r in zip(got["embeddings"], ref["embeddings"]):
            assert {k for k, v in g.items() if v > 1e-4} == {k for k, v in r.items() if v > 1e-4}
            for k in g.keys() & r.keys():
                assert g[k] == pytest.approx(r[k], rel=1e-4, abs=1e-5)


def test_concurrent_burst(servers):
    """16 clients at once: every response equals the other package's and
    this package's own sequential answer; the burst coalesced."""
    words = ["the", "data", "model", "system", "network", "of", "cat", "learning"]
    bodies = [{"query": {"neural_sparse": {"text_sparse": {"query_tokens": {
        words[j % 8]: 1.0 + 0.1 * j, words[(3 * j + 1) % 8]: 0.5}}}}, "size": 5 + j % 3}
        for j in range(16)]
    for b in bodies[:4]:
        b["query"]["neural_sparse"]["text_sparse"] = {
            "query_text": " ".join(servers["queries"][0].split()[:3]), "inf_free": True}
    out = {}
    for side in ("jax", "torch"):
        seq = [_call(servers[side], "POST", "/rq/_search", b)[1] for b in bodies]
        before = _call(servers[side], "GET", "/_stats")[1]["search_microbatch"]
        with ThreadPoolExecutor(16) as ex:
            burst = list(ex.map(lambda b: _call(servers[side], "POST", "/rq/_search", b), bodies))
        assert all(code == 200 for code, _ in burst)
        stats = _call(servers[side], "GET", "/_stats")[1]["search_microbatch"]
        assert stats["batches"] - before["batches"] < 16 and stats["max_batch_seen"] >= 2
        for (_, b), s in zip(burst, seq):
            assert b["hits"] == s["hits"]
        out[side] = seq
    for got, ref in zip(out["torch"], out["jax"]):
        _assert_same_hits(got, ref)


def test_microbatch_pads_to_pow2_buckets(servers):
    """Token groups reach the index padded to a power-of-two batch; a
    full-forward text group reaches it with its real rows only, an
    inference-free one padded (its pad rows are zero)."""
    state = servers["tstate"]
    seen = []
    orig_tokens, orig_search = SparseIndex.search_tokens, SparseIndex.search

    def spy_tokens(self, q_tok, q_w, **kw):
        seen.append(("tokens", q_tok.shape[0]))
        return orig_tokens(self, q_tok, q_w, **kw)

    def spy_search(self, q, **kw):
        seen.append(("search", q.shape[0]))
        return orig_search(self, q, **kw)

    SparseIndex.search_tokens, SparseIndex.search = spy_tokens, spy_search
    try:
        for n in (3, 5, 6):
            reqs = [tserve._SearchRequest("testidx", "tokens",
                                          [(100 + j, 1.0), (200 + j, 0.5)][: 1 + j % 2],
                                          5, 0.0, False) for j in range(n)]
            state.batcher._execute(reqs)
            assert all(r.result is not None and r.certified is None for r in reqs)
        for inf_free in (True, False):
            reqs = [tserve._SearchRequest("rq", "text", (f"some document text {j}", inf_free),
                                          5, 0.0, False) for j in range(3)]
            state.batcher._execute(reqs)
            assert all(r.result is not None for r in reqs)
    finally:
        SparseIndex.search_tokens, SparseIndex.search = orig_tokens, orig_search
    tokens = [n for kind, n in seen if kind == "tokens"]
    assert tokens == [4, 8, 8]
    assert [n for kind, n in seen if kind == "search"][-2:] == [4, 3]


def test_bulk_encodes_raw_text_in_bounded_batches(servers, monkeypatch):
    """A bulk of 40 raw-text docs, more than the server's max_batch of 16:
    the encoder's forwards never see more than 16 rows (40 docs run as 3
    batches), and the rows stored are those of each doc encoded alone."""
    state = servers["tstate"]
    texts = servers["texts"][:40]
    state.create_index("bounded", {"settings": {"index": {"l_max": 16, "engine": "sparse"}}})
    index = state.indexes["bounded"]
    forward, add, forwards, stored = state.model.bert.encode_hidden, index.add_topk, [], []

    def counted(ids, mask, **kw):
        forwards.append(ids.shape[0])
        return forward(ids, mask, **kw)

    def recorded(ids, toks, ws):
        stored.append((ids, toks, ws))
        return add(ids, toks, ws)

    monkeypatch.setattr(state.model.bert, "encode_hidden", counted)
    monkeypatch.setattr(index, "add_topk", recorded)
    try:
        out = state.bulk(_bulk_body([("bounded", f"b{i}", {"text": t})
                                     for i, t in enumerate(texts)]))
    finally:
        monkeypatch.undo()
        state.delete_index("bounded")
    assert out["errors"] is False and len(out["items"]) == len(texts)
    assert forwards == [8, 16, 16]
    [(ids, toks, ws)] = stored
    assert ids == [f"b{i}" for i in range(len(texts))]
    enc = state.encoder
    for r, t in enumerate(texts):
        si, sw = enc.resolve_chunk_sparse(*enc.encode_chunk_sparse_async([t], l_max=16, rows=1))
        np.testing.assert_allclose(ws[r], sw[0], rtol=0, atol=RTOL)
        edge = sw[0, -1] + RTOL  # below this, ids may swap between near-ties
        assert ({int(i) for i, w in zip(toks[r], ws[r]) if w > edge}
                == {int(i) for i, w in zip(si[0], sw[0]) if w > edge}), r

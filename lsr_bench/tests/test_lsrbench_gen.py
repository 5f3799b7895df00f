"""The generators repeat for a seed, keep the work fixed across seeds, and
the frozen WordPiece copy tokenizes as the port does."""

import numpy as np
import pytest
import torch

from lsr_bench.gen import corpus, text
from lsr_bench.reference.wordpiece import WordPiece


def test_texts_repeat_for_a_seed_and_keep_their_lengths_across_seeds():
    words = text.Words(1.0)

    def make(seed):
        rng = np.random.default_rng(seed)
        lens = text.lognormal_lengths(200, 60, 0.6, 8, 600, rng)
        return lens, text.make_texts(words, lens, rng)

    (l1, t1), (l2, t2), (l3, t3) = make(2**31 + 5), make(2**31 + 5), make(7)
    assert t1 == t2 and (l1 == l2).all()
    assert t1 != t3 and sorted(l1) == sorted(l3)  # the same work, in another order
    assert [len(s.split()) for s in t1] == l1.tolist()


def test_each_word_is_one_wordpiece():
    wp = WordPiece()
    rng = np.random.default_rng(3)
    lens = np.array([5, 40, 700])
    texts = text.make_texts(text.Words(1.0), lens, rng)
    got = [len(wp.encode_ids(s, 512)) for s in texts]
    assert got == text.token_counts(lens, 512).tolist()


def test_corpus_repeats_and_keeps_bench_py_invariants():
    a = corpus.make_corpus(3000, 30522, 80, 2**31 + 9, 96, "cpu", chunk=1024)
    b = corpus.make_corpus(3000, 30522, 80, 2**31 + 9, 96, "cpu", chunk=1024)
    c = corpus.make_corpus(3000, 30522, 80, 11, 96, "cpu", chunk=1024)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    toks, ws = a
    live = ws > 0
    n = live.sum(1)
    assert 70 < float(n.float().mean()) < 85 and int(n.min()) >= 1
    assert (ws[:, 1:] <= ws[:, :-1]).all()  # impact-sorted
    for r in range(0, 3000, 97):  # unique tokens a doc
        t = toks[r][live[r]]
        assert len(set(t.tolist())) == len(t)
    assert (toks[~live] == 0).all()


def test_queries_repeat_and_weigh_by_idf():
    q1 = corpus.make_queries(50, 30522, 6, 2**31 + 1)
    q2 = corpus.make_queries(50, 30522, 6, 2**31 + 1)
    assert (q1[0] == q2[0]).all() and (q1[1] == q2[1]).all()
    _, idf = corpus.token_dist(30522)
    tok, w = q1
    assert ((w > 0).sum(1) == 6).all()
    assert np.allclose(w[w > 0], idf[tok[w > 0]])


@pytest.mark.parametrize("s", ["Hello, World! it's 3.5 km", "naive cafe [SEP] x", "déjà vu",
                               "tab\tsep\nline", "a-b_c", "UPPER lower 123abc"])
def test_wordpiece_fast_path_equals_the_loop(s):
    wp = WordPiece()
    assert wp.basic_tokenize(s) == wp.basic_tokenize_slow(s)


def test_frozen_wordpiece_equals_the_ports():
    from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import load_tokenizer

    port = load_tokenizer(None)
    wp = WordPiece()
    rng = np.random.default_rng(5)
    texts = text.make_texts(text.Words(1.0), text.lognormal_lengths(40, 60, 0.6, 3, 600, rng),
                            rng) + ["Hello, World! it's naïve", "unaffable xyzzyq"]
    a = port.encode_bucketed(texts, 512, [64, 128, 256, 512])
    b = wp.batch(texts, 512)
    assert (a["input_ids"] == b["input_ids"]).all()
    assert (a["attention_mask"] == b["attention_mask"]).all()

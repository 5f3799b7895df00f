"""The operation and byte counts, on shapes worked by hand."""

import pytest

from lsr_bench import roofline
from lsr_bench.weights import make_weights, model_keys, n_params, padded_vocab

M = {"hidden_size": 4, "intermediate_size": 8, "vocab_size": 10, "num_hidden_layers": 2}


def test_encoder_forward_flops_by_hand():
    # one doc of 3 tokens: per layer 8*3*16 + 4*3*4*8 + 4*9*4 = 384 + 384 + 144 = 912;
    # two layers 1824; head 2*3*16 + 2*3*4*10 = 96 + 240 = 336
    assert roofline.encoder_forward_flops(M, [3]) == 1824 + 336
    assert roofline.encoder_forward_flops(M, [3, 3]) == 2 * (1824 + 336)
    assert roofline.train_step_flops(M, [3]) == 3 * (1824 + 336)


def test_head_counts_by_hand():
    assert roofline.head_flops(5, 4, 10) == 400
    # h 2*3*4*2=48, mask 2*3*4=24, w 10*4*2=80, bias 40; out 2*10*4=80 (+80 argmax)
    assert roofline.head_bytes(2, 3, 4, 10, False) == 48 + 24 + 80 + 40 + 80
    assert roofline.head_bytes(2, 3, 4, 10, True) == 48 + 24 + 80 + 40 + 160
    assert roofline.head_bound_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.head_bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_mini_weights_match_the_published_size():
    import json
    import os

    from lsr_bench import harness

    m = model_keys(json.load(open(os.path.join(harness.BENCH_DIR, "configs", "bert-mini.json"))))
    # BERT-Mini: 11.2M parameters (embeddings 7.9M with 30 522 rows); the
    # port pads the vocabulary to 30 592 rows and has no pooler
    assert padded_vocab(30522) == 30592
    assert 11.0e6 < n_params(m) < 11.4e6
    w = make_weights(m, 2**31 + 3, "cpu")
    assert float(w["embeddings.word_embeddings"][30522:].abs().sum()) == 0.0
    assert abs(float(w["layers.0.ffn.intermediate.weight"].std()) - 0.02) < 1e-3
    w2 = make_weights(m, 2**31 + 3, "cpu")
    assert all((w[k] == w2[k]).all() for k in w)

"""Learned-sparse retrieval on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of `opensearch_sparse_model_tuning_sample_tpu`, which stays
in the repository as the reference. This package imports torch, never jax,
and nothing of the JAX package. The ported slice so far is the serving path
of `cli.evaluate_beir`: encode a corpus with the BERT-MLM sparse encoder
(whose masked max-pool head is a hand-written Hopper kernel, ops/maxpool.py
+ csrc/maxpool_head.cu), keep the top `l_max` (token, weight) pairs per doc,
build the exact index, encode inference-free queries, search, and score
with trec_eval NDCG.

Layout:
    core/      config system + device/dtype policy
    models/    BERT-MLM module, sparse encoder, tokenizer, HF import
    ops/       activations, the fused max-pool head and its kernel build
    csrc/      CUDA sources of the kernels
    data/      corpus datasets
    index/     the exact on-device sparse index (sparse scan + dense oracle)
    eval/      BEIR harness + trec-eval metrics + metrics sink
    cli/       evaluate entry point
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API: importing the package loads nothing heavy."""
    if name in ("build_model", "BatchEncoder", "SparseEncoderModel"):
        from .models import sparse_encoder as _se

        return getattr(_se, name)
    if name in ("SparseIndex", "IndexConfig"):
        from .index import engine as _engine

        return getattr(_engine, name)
    if name in ("WordPieceTokenizer", "ByteLevelBPETokenizer", "load_tokenizer"):
        from .models import tokenizer as _tok

        return getattr(_tok, name)
    if name == "resolve_device":
        from .core.device import resolve_device

        return resolve_device
    raise AttributeError(name)

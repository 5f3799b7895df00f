"""Learned-sparse retrieval on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of `opensearch_sparse_model_tuning_sample_tpu`, which stays
in the repository as the reference. This package imports torch, never jax,
and nothing of the JAX package. The ported slices so far are mine -> train ->
evaluate: `cli.mine` (hard negatives from the exact index), `cli.train_ir`
(losses, FLOPS regulariser, AdamW, checkpoint export) and
`cli.evaluate_beir` (encode a corpus with the BERT-MLM sparse encoder, keep
the top `l_max` (token, weight) pairs per doc, build the exact index,
encode inference-free queries, search, score with trec_eval NDCG). The
encoder's masked max-pool head is a hand-written Hopper kernel with a
gradient (ops/maxpool.py + csrc/maxpool_head.cu, csrc/maxpool_head_bwd.cu).

Layout:
    core/      config system + device/dtype policy
    models/    BERT-MLM module, sparse encoder, tokenizer, HF import
    ops/       activations, losses, FLOPS, the fused max-pool head + kernel build
    csrc/      CUDA sources of the kernels
    data/      corpus and training datasets, collator, loader
    train/     the train step and loop
    mine/      hard-negative mining
    index/     the exact on-device sparse index (sparse scan + dense oracle)
    eval/      BEIR harness + trec-eval metrics + metrics sink
    cli/       mine, train_ir and evaluate_beir entry points
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

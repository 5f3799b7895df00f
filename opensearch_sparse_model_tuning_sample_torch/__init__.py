"""Learned-sparse retrieval on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of `opensearch_sparse_model_tuning_sample_tpu`, which stays
in the repository as the reference. This package imports torch, never jax,
and nothing of the JAX package. It covers the JAX package's paths: mining
(`cli.mine`), training with distillation and data-parallel launches
(`cli.train_ir`), evaluation (`cli.evaluate_beir`), serving (`cli.serve`,
`cli.search`), and the on-device index on one device or sharded over a
mesh of devices inside one process (`make_mesh`). The encoder's masked
max-pool head is a hand-written Hopper kernel with a gradient
(ops/maxpool.py + csrc/maxpool_head.cu, csrc/maxpool_head_bwd.cu).

Layout:
    core/      config system + device/dtype policy + the device mesh
    models/    BERT-MLM module, sparse encoder, tokenizer, HF import
    ops/       activations, losses, FLOPS, the fused max-pool head + kernel build
    csrc/      CUDA sources of the kernels
    data/      corpus and training datasets, collator, loader
    train/     the train step and loop
    mine/      hard-negative mining
    parallel/  collectives (data-parallel train step, the mesh's merge) + dry run
    index/     the on-device sparse index (scan, dense oracle, inverted engine;
               single-device, doc- or query-sharded over a mesh)
    eval/      BEIR harness + trec-eval metrics + metrics sink
    cli/       the entry points (mine, train_ir, evaluate_beir, serve, search, ...)
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
    if name == "make_mesh":
        from .core.mesh import make_mesh

        return make_mesh
    if name == "resolve_device":
        from .core.device import resolve_device

        return resolve_device
    raise AttributeError(name)

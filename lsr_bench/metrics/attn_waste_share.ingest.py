"""attn_waste_share.ingest: 100 x (1 - real pairs / computed pairs) of the
attention cores over every ingest call the process ran (the warm-up and
both halves). Real: the driver's exact count, n² a doc in a global layer
and the windowed P(n) in a local one. Computed: the program's counters
`encoder.attn.pairs.global` and `.local`, the pairs its kernels compute
(padding and the masked pairs inside computed blocks included). None where
the program has no such counters."""


def read(run):
    real = getattr(run.driver, "attn_real_pairs", None)
    try:
        from opensearch_sparse_model_tuning_sample_torch.utils import tracing
    except ImportError:
        return None
    c = tracing.counters()
    computed = c.get("encoder.attn.pairs.global", 0) + c.get("encoder.attn.pairs.local", 0)
    if not real or not computed:
        return None
    return 100.0 * (1.0 - sum(real.values()) / computed)

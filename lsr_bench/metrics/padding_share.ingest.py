"""padding_share.ingest: 100 x (1 - encoder.tokens / encoder.positions),
the program's counters over the process's ingest calls (the warm-up and
both halves, which take the same corpora): the share of the positions the
encoder runs that are padding, to the chunk's bucket and to its
power-of-two batch count. None where the program has no such counters."""


def read(run):
    try:
        from opensearch_sparse_model_tuning_sample_torch.utils import tracing
    except ImportError:
        return None
    c = tracing.counters()
    positions = c.get("encoder.positions", 0)
    if not positions:
        return None
    return 100.0 * (1.0 - c.get("encoder.tokens", 0) / positions)

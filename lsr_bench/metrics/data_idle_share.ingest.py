"""data_idle_share.ingest: the card's idle time that began while the host
was inside the program's `data.*` spans (`data.tokenize`: the rows, the
tokenizer and the padding; `data.copy_in`: ids and mask to the card), over
(profiled window x cards), in percent.

It counts only the gaps that *begin* in the layer, as the trace books a gap
whole under the span open when it began (`lsr_bench/idle_split.py` splits
each gap over the spans open during it; no reader can, as the trace keeps
no host ranges). With encoder_idle_share.ingest, index_idle_share.ingest,
the idle left under the bare `ingest` range and `outside_ranges`, it
partitions idle_share.ingest. None where the trace holds no `data.*` span
(a program without them)."""

from lsr_bench.idle_split import layer_idle_share


def read(run):
    return layer_idle_share(run, "data")

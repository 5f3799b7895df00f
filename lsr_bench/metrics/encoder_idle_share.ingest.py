"""encoder_idle_share.ingest: the card's idle time that began while the host
was inside the program's `encoder.*` spans (`encoder.forward`, `.head`,
`.topk`, `.copy_out`: the host issuing or copying slower than the card
runs), over (profiled window x cards), in percent.

It counts only the gaps that *begin* in the layer, as the trace books a gap
whole under the span open when it began: a gap that begins while the host
waits in `encoder.copy_out`'s copy back and lasts while it adds and
tokenizes is booked here (`lsr_bench/idle_split.py` splits each gap over
the spans open during it). With data_idle_share.ingest,
index_idle_share.ingest, the bare `ingest` and `outside_ranges`, it
partitions idle_share.ingest. None where the trace holds no `encoder.*`
span (a program without them)."""

from lsr_bench.idle_split import layer_idle_share


def read(run):
    return layer_idle_share(run, "encoder")

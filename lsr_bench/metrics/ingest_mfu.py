"""ingest_mfu: the encoder forward's operations over the docs' real tokens
over the unprofiled half's wall time times the card's bf16 peak, in
percent."""

from lsr_bench.roofline import PEAK_BF16_FLOPS


def read(run):
    h = run.first
    if not h.units or h.seconds <= 0:
        return None
    return 100.0 * h.total("flops") / (h.seconds * PEAK_BF16_FLOPS * run.cell.chips)

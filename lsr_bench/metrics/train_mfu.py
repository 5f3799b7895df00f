"""train_mfu: the model operations of the docs' real tokens (forward and
backward of the encoder and the head; inference-free queries run none) over
the unprofiled half's wall time times the cards' bf16 peak, in percent."""

from lsr_bench.roofline import PEAK_BF16_FLOPS


def read(run):
    h = run.first
    if not h.units or h.seconds <= 0:
        return None
    return 100.0 * h.total("flops") / (h.seconds * PEAK_BF16_FLOPS * run.cell.chips)

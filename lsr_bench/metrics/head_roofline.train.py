"""head_roofline.train: the least time the training forward of the head
needs (the larger of 2 unmasked D V operations at the bf16 peak and its
bytes read and written once at the HBM peak, V the published vocabulary)
over the device time of the operations launched inside the call to
`maxpool_head_train` where `models/bert.py` makes it (the range
`lsr.head`), over the profiled half, in percent."""

from lsr_bench import roofline


def read(run):
    tr = run.trace
    busy = None if tr is None else tr.range_device_s.get("head")
    if not busy:
        return None
    V = run.driver.m["vocab_size"]
    bound = roofline.head_bound_s(run.second.total("head_flops"), run.driver.head.bytes(V, True))
    return 100.0 * bound / busy

"""head_roofline.ingest: as head_roofline.train, for the ingest forward
(`maxpool_head`, no argmax written), over the profiled half's ingest
calls, in percent."""

from lsr_bench import roofline


def read(run):
    tr = run.trace
    busy = None if tr is None else tr.range_device_s.get("head")
    if not busy:
        return None
    V = run.driver.m["vocab_size"]
    bound = roofline.head_bound_s(run.second.total("head_flops"), run.driver.head.bytes(V, False))
    return 100.0 * bound / busy

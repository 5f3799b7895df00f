"""moe_roofline.ingest: the routed experts' grouped GEMMs over the profiled
half's docs, their least time (`drivers/moonlight_roofline.py`: per expert
layer and batch the larger of 2·R·3·D·I operations at 989 TFLOP/s, R = k
rows a real token, and every held expert's weights once plus the rows in
and out in bf16 at 3.35 TB/s) over the union of the device time launched
inside the port's span `encoder.moe.experts`, in percent. None where the
program has no such span."""


def read(run):
    tr = run.trace
    busy = None if tr is None else tr.range_device_s.get("encoder.moe.experts")
    if not busy:
        return None
    return 100.0 * run.second.total("moe_bound_s") / busy

"""attn_causal_roofline.ingest: the causal attention cores over the profiled
half's docs, their least time (`drivers/moonlight_roofline.py`: per doc and
layer the larger of n(n + 1)/2 · H · 2 · (hqk + hv) operations at 989
TFLOP/s and q, k, v, o once in bf16 at 3.35 TB/s) over the union of the
device time launched inside the port's span `encoder.attn.causal`, in
percent. None where the program has no such span."""


def read(run):
    tr = run.trace
    busy = None if tr is None else tr.range_device_s.get("encoder.attn.causal")
    if not busy:
        return None
    return 100.0 * run.second.total("attn_causal_bound_s") / busy

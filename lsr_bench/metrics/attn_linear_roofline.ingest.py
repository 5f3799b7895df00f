"""attn_linear_roofline.ingest: the KDA mixers over the profiled half's
docs, their least time (`drivers/kimi_linear_roofline.py`: per doc and KDA
layer the larger of n·H·6·dk·dv operations at 989 TFLOP/s and q, k, v, the
decay's and the output gate's pre-activations and o once in bf16, β in
fp32, at 3.35 TB/s) over the union of the device time launched inside the
port's span `encoder.attn.linear`, in percent. None where the program has
no such span."""


def read(run):
    tr = run.trace
    busy = None if tr is None else tr.range_device_s.get("encoder.attn.linear")
    if not busy:
        return None
    return 100.0 * run.second.total("attn_linear_bound_s") / busy

"""attn_global_roofline.ingest: the global layers' attention cores over the
profiled half's docs, their least time (`drivers/modernbert_roofline.py`:
per doc and layer the larger of 4·n²·D operations at 989 TFLOP/s and
q, k, v, o once in bf16 at 3.35 TB/s) over the union of the device time
launched inside the port's span `encoder.attn.global`, in percent. None
where the program has no such span."""


def read(run):
    tr = run.trace
    busy = None if tr is None else tr.range_device_s.get("encoder.attn.global")
    if not busy:
        return None
    return 100.0 * run.second.total("attn_global_bound_s") / busy

"""attn_local_roofline.ingest: as attn_global_roofline.ingest, for the local
(windowed) layers: per doc and layer the larger of 4·P·D operations, P the
pairs with |i - j| <= local_attention / 2, and the same bytes, over the
device time launched inside `encoder.attn.local`, in percent."""


def read(run):
    tr = run.trace
    busy = None if tr is None else tr.range_device_s.get("encoder.attn.local")
    if not busy:
        return None
    return 100.0 * run.second.total("attn_local_bound_s") / busy

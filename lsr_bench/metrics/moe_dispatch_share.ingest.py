"""moe_dispatch_share.ingest: the device time launched inside the port's
spans `encoder.moe.route` (router, top-k, weights) and
`encoder.moe.permute` (the sort, the gather of the rows, the combine) over
that inside all three `encoder.moe.*` spans (with `encoder.moe.experts`,
the grouped GEMMs), over the profiled half, in percent. Lower is better:
what the expert layer spends moving rows rather than multiplying them.
None where the program has no such spans."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    s = {k: tr.range_device_s.get("encoder.moe." + k, 0.0)
         for k in ("route", "permute", "experts")}
    if not s["experts"]:
        return None
    return 100.0 * (s["route"] + s["permute"]) / sum(s.values())

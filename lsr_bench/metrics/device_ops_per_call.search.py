"""device_ops_per_call.search: device operations the profiled half ran per
`search_tokens` call."""


def read(run):
    calls = run.second.total("calls")
    if run.trace is None or not calls or not run.trace.n_ops:
        return None
    return run.trace.n_ops / calls

"""idle_share.search: 1 - (union of the device operations' intervals on the
cell's cards) / (profiled window x cards), in percent."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.devices:
        return None
    return 100.0 * (1.0 - tr.busy_mean_s / tr.window_s)

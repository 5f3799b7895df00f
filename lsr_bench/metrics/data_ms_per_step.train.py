"""data_ms_per_step.train: host milliseconds a step spends fetching its
batch from the port's loader (tokenize and collate; the span `lsr.data`),
over the profiled half's steps."""


def read(run):
    steps = run.second.total("steps")
    if not steps:
        return None
    return 1e3 * run.second.total("data_s") / steps

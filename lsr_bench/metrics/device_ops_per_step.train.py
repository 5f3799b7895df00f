"""device_ops_per_step.train: device operations (kernels, copies, sets) the
profiled half ran on all its cards, per train step."""


def read(run):
    steps = run.second.total("steps")
    if run.trace is None or not steps or not run.trace.n_ops:
        return None
    return run.trace.n_ops / steps

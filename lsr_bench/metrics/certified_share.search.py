"""certified_share.search: the share of the window's queries that the
inverted engine's base pass certified, so that they did not escalate
(`SparseIndex.last_escalated` after each call), in percent."""


def read(run):
    q = run.first.total("queries") + run.second.total("queries")
    if not q:
        return None
    esc = run.first.total("escalated") + run.second.total("escalated")
    return 100.0 * (1.0 - esc / q)

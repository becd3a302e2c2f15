"""Host CPU the node pays per labeling cycle: the user and system seconds
of the daemon and every process it started (the broker worker) over the
window, per cycle."""


def read(run):
    return run.cpu_s / run.cycles * 1e3 if run.cycles else None

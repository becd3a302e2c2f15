"""File and directory fsyncs per labeling cycle: the window's rise of
``tfd_fsyncs_total`` over every ``file`` (labels, state, timings) over its
cycles. Counted in work, not time, so the host's speed does not move it.
Nothing where the program has no such counter."""

FAMILY = "tfd_fsyncs_total{"


def read(run):
    keys = [k for k in run.scrape_end if k.startswith(FAMILY)]
    if not keys or run.cycles < 1:
        return None
    return sum(run.delta(k) for k in keys) / run.cycles

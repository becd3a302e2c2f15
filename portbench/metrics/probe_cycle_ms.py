"""How long labels wait for a probe: the window's wall time over the
probing cycles completed in it (heartbeat to heartbeat)."""


def read(run):
    if run.cycles < 1:
        return None
    return (run.stamps[-1] - run.stamps[0]) / run.cycles * 1e3

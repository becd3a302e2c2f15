"""How often the daemon tries a busy card: the busy phase's wall time over
its labeling cycles (heartbeat to heartbeat); nothing without a tenant."""


def read(run):
    if len(run.busy_stamps) < 2:
        return None
    return (run.busy_stamps[-1] - run.busy_stamps[0]) / (len(run.busy_stamps) - 1) * 1e3

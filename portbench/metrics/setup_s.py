"""A restarted pod without health labels: the daemon's start to its first
label write with health labels, then the warm-up, to the window's first
heartbeat."""


def read(run):
    return run.setup_s

"""The part of the time between two probes' device windows that the loop
layer holds (``tfd_probe_gap_seconds`` of ``loop``: the labeling loop
outside ``labelgen.total``: the write and its fsyncs, the state save,
the heartbeat, the log, the wait), its mean over the window's edges;
nothing where the program records no such split."""


def read(run):
    mean = run.delta_mean("tfd_probe_gap_seconds", '{layer="loop"}')
    return None if mean is None else mean * 1e3

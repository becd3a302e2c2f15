"""The part of the time between two probes' device windows that the labelgen
layer holds (``tfd_probe_gap_seconds`` of ``labelgen``: the label cycle
outside the health labeler: ``labelgen.total`` before it starts and
after it returns), its mean over the window's edges; nothing where the
program records no such split."""


def read(run):
    mean = run.delta_mean("tfd_probe_gap_seconds", '{layer="labelgen"}')
    return None if mean is None else mean * 1e3

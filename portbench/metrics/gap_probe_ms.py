"""The part of the time between two probes' device windows that the probe
layer holds (``tfd_probe_gap_seconds`` of ``probe``: the probe's host
time outside its device window: the health labeler outside the broker's
pipe, the worker's receipt to the first launch, the report and the
reply), its mean over the window's edges; nothing where the program
records no such split."""


def read(run):
    mean = run.delta_mean("tfd_probe_gap_seconds", '{layer="probe"}')
    return None if mean is None else mean * 1e3

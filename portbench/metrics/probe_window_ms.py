"""The probe's device window (``tfd_span_duration_seconds`` of
``probe.device``: its first launch to its last readback, the verdict pass
included), its mean over the window's edges; nothing where the program
records no such span."""


def read(run):
    mean = run.delta_mean("tfd_span_duration_seconds", '{span="probe.device"}')
    return None if mean is None else mean * 1e3

"""The labeling cycle's own root span (``tfd_span_duration_seconds`` of
``cycle``: the loop's top to the end of its wait), its mean over the
window's edges; the inside counterpart of ``probe_cycle_ms``. Nothing
where the program records no span tree."""


def read(run):
    mean = run.delta_mean("tfd_span_duration_seconds", '{span="cycle"}')
    return None if mean is None else mean * 1e3

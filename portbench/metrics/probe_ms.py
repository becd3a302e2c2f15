"""The health labeler's wall time (``tfd_labeler_duration_seconds`` of
``health``): its mean over the window's edges."""


def read(run):
    mean = run.delta_mean("tfd_labeler_duration_seconds", '{labeler="health"}')
    return None if mean is None else mean * 1e3

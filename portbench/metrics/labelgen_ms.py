"""The label cycle's own span (``labelgen.total``, the
``tfd_cycle_duration_seconds`` histogram): its mean over the window's
edges. The rest of ``probe_cycle_ms`` is the loop around it."""


def read(run):
    mean = run.delta_mean("tfd_cycle_duration_seconds")
    return None if mean is None else mean * 1e3

"""The failed attempts' broker round trips: the mean of the health RPC's
own span (``tfd_span_duration_seconds`` of ``broker.rpc.health``) over
the busy phase's edge scrapes; every health RPC there is a busy attempt.
Nothing without a tenant or where the program records no such span."""


def read(run):
    mean = run.busy_mean("tfd_span_duration_seconds", '{span="broker.rpc.health"}')
    return None if mean is None else mean * 1e3

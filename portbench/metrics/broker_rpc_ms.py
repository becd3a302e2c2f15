"""The broker's pipe RPCs (``tfd_broker_request_duration_seconds``): the
mean round trip over the window's edges; nothing where no RPC ran."""


def read(run):
    mean = run.delta_mean("tfd_broker_request_duration_seconds")
    return None if mean is None else mean * 1e3

"""The part of the time between two probes' device windows that the broker
layer holds (``tfd_probe_gap_seconds`` of ``broker``: the broker's pipe both
ways: ``broker.rpc.health`` less ``worker.health``), its mean over the
window's edges; nothing where the program records no such split."""


def read(run):
    mean = run.delta_mean("tfd_probe_gap_seconds", '{layer="broker"}')
    return None if mean is None else mean * 1e3

"""Card time a probe takes from the node's workloads: the seconds in
which the probe's cards ran any operation, summed over them, in a device
trace of its own after the window, over the probes that ended inside it."""

import work


def read(run):
    busy = sum(d["busy_s"] for t in run.traces for d in t["devices"].values())
    return work.per_probe_ms(run, busy)

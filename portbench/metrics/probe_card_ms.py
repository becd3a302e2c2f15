"""Card time a probe takes from the node's workloads: the seconds in
which the probe's cards ran any operation, summed over them, in a device
trace of its own after the window, over the probes that ended inside it."""


def read(run):
    busy = 0.0
    probes = 0
    for t in run.traces:
        busy += sum(d["busy_s"] for d in t["devices"].values())
        probes += sum(1 for r in run.records if t["t0"] <= r["t"] <= t["t1"])
    return busy / probes * 1e3 if probes else None

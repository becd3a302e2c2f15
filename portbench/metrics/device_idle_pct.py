"""The share of the traced window in which the card ran no operation,
averaged over the cards the probe ran on."""


def read(run):
    devices = [d for t in run.traces for d in t["devices"].values()]
    window = max((t["host_window_s"] for t in run.traces), default=0.0)
    if not devices or window <= 0:
        return None
    busy = sum(d["busy_s"] for d in devices) / len(devices)
    return 100.0 * (1.0 - busy / window)

"""The burn-in pass against its roofline: the least time of one pass at
the configuration's geometry (its products' FLOPs at the bf16 peak, or
its inputs' bytes at the HBM peak, whichever is longer) over the device
time of one pass, taken as all kernels of all the traced window's
CUDA-graph replays over the replays; nothing where the trace holds no
replay."""

import work


def read(run):
    peaks = run.peaks()
    replays = sum(t["graph"]["replays"] for t in run.traces)
    if peaks is None or not replays:
        return None
    probe = run.config["probe"]
    bound = work.bound_s(work.burnin_flops(probe["size"], probe["depth"]),
                         work.burnin_bytes(probe["size"], probe["depth"]), peaks)
    return work.share(bound, sum(t["graph"]["seconds"] for t in run.traces) / replays)

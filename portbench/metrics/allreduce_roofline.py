"""The timed all-reduce's NCCL kernel against its roofline: the ring's bus
bytes per card, 2(n-1)/n of the configuration's payload, at NVLink 4's
peak in one direction, over the float32 all-reduce kernels' mean device
time per launch in the traced window (each card's launch counted; the
int32 reductions of the verdicts and the sweep are told apart by the
type in the kernel's name); nothing on one card or where the trace holds
no such kernel."""

import work


def read(run):
    peaks = run.peaks()
    n = run.cell["chips"]
    seconds, launches = work.ops_time(run.traces, work.NCCL_ALLREDUCE_F32)
    if peaks is None or n < 2 or not launches:
        return None
    bound = work.ring_bus_bytes(n, run.config["probe"]["allreduce_mib"]) / peaks["nvlink_bytes"]
    return work.share(bound, seconds / launches)

"""The ``hbm_stream_sum`` kernel against its roofline: the buffer's bytes
read once at the HBM peak over the kernel's device time per launch in the
traced window (its ``stream_sum`` kernel); nothing where the trace holds
no launch."""

import work


def read(run):
    peaks = run.peaks()
    seconds, launches = work.kernel_time(run.traces, "stream_sum")
    if peaks is None or not launches:
        return None
    bound = work.stream_bytes(run.config["probe"]["hbm_mib"]) / peaks["hbm_bytes"]
    return work.share(bound, seconds / launches)

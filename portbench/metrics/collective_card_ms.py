"""Card time the probe's collectives take: every NCCL kernel (the verdict
pass's and the sweep's int32 reductions, the timed float32 all-reduce
and its warm-up), per probe, summed over the cards; nothing where the
trace holds no NCCL kernel (one card needs no NCCL)."""

import work


def read(run):
    seconds, _ = work.ops_time(run.traces, work.NCCL_KERNEL)
    return work.per_probe_ms(run, seconds)

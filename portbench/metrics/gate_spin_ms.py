"""Card time the all-reduce's timing gate spends: the spin that holds each
card's stream shut until the host has queued every timed call
(``torch.cuda._sleep``'s ``spin_kernel``), per probe, summed over the
cards; nothing where the trace holds no spin (one card has no gate)."""

import work


def read(run):
    seconds, _ = work.kernel_time(run.traces, "spin_kernel")
    return work.per_probe_ms(run, seconds)

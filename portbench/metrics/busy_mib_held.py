"""Card memory the daemon keeps beside a job that fills the card, in MiB,
on the fullest card: NVML's device-wide used memory at the busy phase's
last ``LAST`` heartbeats, the least of them, less the card's once the
tenant held its memory; nothing without a tenant. Each reading is taken
as its heartbeat is seen, between two attempts, but the next attempt may
already hold its inputs: the least of a few skips that. Only the last
few count, so that memory kept by each failed attempt shows as all the
attempts before them kept it, not as one attempt's worth."""

LAST = 5


def read(run):
    if not run.used_tenant or not run.busy_used:
        return None
    held = [min(card) for card in zip(*run.busy_used[-LAST:])]
    return max(busy - tenant for tenant, busy in zip(run.used_tenant, held)) / 2**20

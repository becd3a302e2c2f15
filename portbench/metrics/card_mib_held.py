"""Card memory taken from the node's workloads: NVML's device-wide used
memory at the window's end less the card's before the daemon started, on
the fullest card, in MiB (the broker worker counts; the harness holds no
CUDA context when it reads this)."""


def read(run):
    if not run.used_base or not run.used_end:
        return None
    return max(end - base for base, end in zip(run.used_base, run.used_end)) / 2**20

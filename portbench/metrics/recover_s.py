"""How soon a card's verdict returns once a job frees it: the tenant's
release, stamped when NVML shows its memory back, to the daemon's first
label write that carries health labels again; nothing without a tenant."""


def read(run):
    return run.recover_s

"""The slow cycles a node's labels wait on: the 95th percentile of every
cycle of the window, each the time between two heartbeats."""

import work


def read(run):
    cycles = [(b - a) * 1e3 for a, b in zip(run.stamps, run.stamps[1:])]
    return work.p95(cycles) if len(cycles) >= 2 else None

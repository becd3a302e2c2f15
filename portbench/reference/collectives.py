"""What a sound probe of a multi-GPU node's collectives reads back, worked
out from the card count alone: the verdict pass's reduced healthy count,
the timed all-reduce's output (all-ones payloads in) and the ring sweep
over a single-axis mesh in row-major order (card i holds rank i and
receives its left neighbour's). Imports nothing of the program."""

from typing import Dict


def expected(n: int, allreduce_mib: int) -> Dict[str, object]:
    """The readings of a healthy ``n``-card node whose timed all-reduce
    moves ``allreduce_mib`` MiB of float32 per card."""
    elements = (allreduce_mib << 20) // 4
    return {
        # Every card healthy, summed over the mesh, on every card.
        "counts": [n] * n,
        # Ones in, so each element of each card's output is n, and its
        # sum n times the element count (exact in float64).
        "element": float(n),
        "sum": float(n * elements),
        # The ring shift delivers the left neighbour's rank.
        "received": [(i - 1) % n for i in range(n)],
        # The ranks 0..n-1 summed, on every card.
        "totals": [n * (n - 1) // 2] * n,
    }

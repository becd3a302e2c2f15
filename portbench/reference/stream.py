"""Plain reference of the probe's HBM stream: the sum of its buffer.

The buffer as the probe states it: ``(rows, 128)`` float32, rows in
chunks of 512, every element of chunk ``c`` holding ``1 + c % 7``, over
``hbm_mib`` MiB rounded down to whole chunks. Every partial sum is an
integer far below float32's mantissa bound, so the sum is exact and a
probe's must equal it. Imports nothing of the program.
"""

import numpy as np

LANES = 128
CHUNK_ROWS = 512
PERIOD = 7


def rows_for(hbm_mib: int) -> int:
    return max(1, (hbm_mib << 20) // (LANES * 4) // CHUNK_ROWS) * CHUNK_ROWS


def buffer_sum(hbm_mib: int) -> float:
    """The buffer's sum, chunk by chunk in integers."""
    chunks = np.arange(rows_for(hbm_mib) // CHUNK_ROWS, dtype=np.int64)
    values = 1 + chunks % PERIOD
    return float(int((values * CHUNK_ROWS * LANES).sum()))

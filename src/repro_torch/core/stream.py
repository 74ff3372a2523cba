"""Stream constants: the SENTINEL pad key and the capacity granule.

A stream is a sorted int32 key row of static capacity, padded with
``SENTINEL`` (2^31-1). Capacities are multiples of ``LANE``; the CUDA
kernels take any such multiple.
"""
from __future__ import annotations

import numpy as np

SENTINEL = int(np.iinfo(np.int32).max)  # 2147483647, "End Of Stream"
LANE = 128  # minimum stream capacity granule


def round_capacity(n: int) -> int:
    """Smallest multiple of LANE >= max(n, 1)."""
    return max(LANE, ((int(n) + LANE - 1) // LANE) * LANE)

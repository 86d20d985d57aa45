"""Per-query valid site ranges (leading/trailing gap trim).

The reference trims only literal '-' characters at either end
(src/util/Range.hpp:34-49); within the range gaps still contribute their
fully-ambiguous likelihood. On the device the range becomes a per-query site mask /
(begin, span) pair consumed by masked reductions instead of the reference's
partition-pointer shifting (src/core/pll/pll_util.cpp:388-418).
"""

from __future__ import annotations

import numpy as np


def get_valid_range(sequence: str) -> tuple[int, int]:
    """Return (begin, span) of the non-gap-flanked core of the sequence."""
    arr = np.frombuffer(sequence.encode("ascii"), dtype=np.uint8)
    nongap = arr != ord("-")
    idx = np.nonzero(nongap)[0]
    if len(idx) == 0:
        return 0, 0
    lower = int(idx[0])
    upper = int(idx[-1]) + 1
    return lower, upper - lower


def valid_ranges(codes_or_seqs, width: int | None = None) -> np.ndarray:
    """Vectorized ranges for a list of sequences: [n, 2] (begin, span)."""
    out = np.zeros((len(codes_or_seqs), 2), dtype=np.int32)
    for i, seq in enumerate(codes_or_seqs):
        out[i] = get_valid_range(seq)
    return out

"""Work sets: sparse (edge -> [query ids]) descriptions of (edge, query)
pairs to compute, with split/merge for distributing across hosts.

Python analog of the reference's Work token (src/core/Work.hpp) and its
set_manipulators split/merge (src/set_manipulators.cpp:9-39): the engine's
hot path consumes flat edge-major pair arrays directly (core.heuristics).

STATUS: forward-looking parity module. ``split``/``merge`` exist for a
work-stealing / stage-parallel future (the reference's Work is likewise
only exercised by its unwired Pipeline engine); the live multi-host
distribution shards queries via reader offsets (parallel.dist,
io.fasta/bfast), not Work sets.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


class Work:
    def __init__(self):
        self._bins: OrderedDict[int, list[int]] = OrderedDict()

    @classmethod
    def from_ranges(cls, branch_range: tuple[int, int],
                    seq_range: tuple[int, int]) -> "Work":
        w = cls()
        seqs = list(range(*seq_range))
        for b in range(*branch_range):
            w._bins[b] = list(seqs)
        return w

    @classmethod
    def from_pairs(cls, edge_ids, query_ids) -> "Work":
        w = cls()
        for e, q in zip(edge_ids, query_ids):
            w.add(int(e), int(q))
        return w

    def add(self, branch_id: int, seq_id: int):
        self._bins.setdefault(branch_id, []).append(seq_id)

    def __len__(self) -> int:
        return sum(len(v) for v in self._bins.values())

    def __bool__(self) -> bool:
        return bool(self._bins)

    def __iter__(self):
        for b, seqs in self._bins.items():
            for s in seqs:
                yield b, s

    def pairs(self) -> tuple[np.ndarray, np.ndarray]:
        """Edge-major flattened (edge_ids, query_ids) arrays."""
        e, q = [], []
        for b, s in self:
            e.append(b)
            q.append(s)
        return (np.asarray(e, dtype=np.int32),
                np.asarray(q, dtype=np.int32))


def split(src: Work, num_parts: int) -> list[Work]:
    """Split into num_parts contiguous chunks (empty parts allowed),
    mirroring set_manipulators.cpp:9-24."""
    parts = [Work() for _ in range(num_parts)]
    n = len(src)
    ext_size = (n - (n % num_parts)) + num_parts
    chunk_size = ext_size // num_parts
    i = 0
    bucket = 0
    for b, s in src:
        parts[bucket].add(b, s)
        i += 1
        if i % chunk_size == 0:
            bucket += 1
    return parts


def merge(dest: Work, src: Work) -> Work:
    for b, s in src:
        dest.add(b, s)
    return dest

"""Pipeline stage scheduling: difficulty-proportional node assignment.

Python re-expression of the reference's rebalancing solver
(src/pipeline/schedule.cpp): measured per-stage times are normalized into
difficulties; ``solve`` assigns nodes proportional to difficulty (first and
last stage pinned to one node); ``assign``/``reassign`` compute and migrate
rank->stage maps with minimal movement.

STATUS: :func:`proportional_shares` IS consumed by the runtime — the
CLI's ``--adaptive-split`` calibrates each host's placement rate
(PlacementEngine.calibration_rate) and shards the query file
rate-proportionally with it (tests/test_torch_dist.py::
test_adaptive_split_two_ranks). The stage-pipeline solver half
(``solve``/``assign``/``reassign``) mirrors the reference's scheduler,
which its own v0.3.8 ``simple_mpi`` path never calls either
(src/pipeline/Pipeline.hpp:35, src/pipeline/schedule.cpp:16-54): kept as
unit-tested math for a cross-host stage pipeline. Nothing feeds it: the
stage times that ``core.pipeline.StreamingPipeline`` records
(``utils/timer.py``) go to the CLI's stage line.
"""

from __future__ import annotations

import math


def to_difficulty(perstage_avg: list[float]) -> list[float]:
    m = min(perstage_avg)
    return [x / m for x in perstage_avg]


def solve(stages: int, nodes: int, difficulty: list[float]) -> list[int]:
    assert len(difficulty) == stages
    if nodes < stages:
        raise ValueError("Must have more or equal number of nodes than stages")

    total = sum(difficulty)
    x1 = nodes / total
    nps = []
    for i in range(stages):
        if i == 0 or i == stages - 1:
            nps.append(1)
        else:
            nps.append(math.ceil(difficulty[i] * x1))

    while True:
        off_by = sum(nps) - nodes
        if off_by == 0:
            break
        j = nps.index(max(nps))
        nps[j] += 1 if off_by < 0 else -1
    return nps


def proportional_shares(total: int, rates) -> list[tuple[int, int]]:
    """Contiguous per-rank (offset, count) query shards proportional to
    measured placement rates — the difficulty-proportional assignment of
    the reference's solver (src/pipeline/schedule.cpp:16-54) applied to
    the data-parallel query axis instead of pipeline stages. This IS the
    runtime consumer of the scheduling math: the CLI's --adaptive-split
    calibrates each host's rate and shards the query file with it
    (replacing the even split of the reference's local_seq_package,
    src/net/epa_mpi_util.cpp:10-30).

    Counts sum exactly to ``total`` (largest-remainder rounding, ties to
    the lower rank so every host computes the identical split without
    communication beyond the rate vector)."""
    rates = [max(float(r), 0.0) for r in rates]
    n = len(rates)
    if n == 0:
        raise ValueError("no ranks")
    s = sum(rates)
    if s <= 0:
        rates = [1.0] * n
        s = float(n)
    exact = [total * r / s for r in rates]
    counts = [int(x) for x in exact]
    rem = total - sum(counts)
    # largest fractional remainders get the leftover queries
    order = sorted(range(n), key=lambda i: (-(exact[i] - counts[i]), i))
    for i in order[:rem]:
        counts[i] += 1
    shares = []
    off = 0
    for c in counts:
        shares.append((off, c))
        off += c
    assert off == total
    return shares


def assign(local_rank: int, nodes_per_stage: list[int]):
    """Fresh contiguous assignment. Returns (rank_assignment, local_stage)."""
    rank_assignm: list[list[int]] = []
    local_stage = -1
    rank = 0
    for stage, n in enumerate(nodes_per_stage):
        stage_ranks = []
        for _ in range(n):
            stage_ranks.append(rank)
            if rank == local_rank:
                local_stage = stage
            rank += 1
        rank_assignm.append(stage_ranks)
    return rank_assignm, local_stage


def reassign(local_rank: int, nodes_per_stage: list[int],
             rank_assignm: list[list[int]], local_stage: int) -> int:
    """Migrate ranks between stages in place, minimally. Returns the (possibly
    updated) local stage."""
    assert len(nodes_per_stage) == len(rank_assignm)
    cut: list[int] = []
    for i, want in enumerate(nodes_per_stage):
        cur = rank_assignm[i]
        to_rm = len(cur) - want
        for _ in range(max(0, to_rm)):
            cut.append(cur.pop())
    it = iter(cut)
    for i, want in enumerate(nodes_per_stage):
        cur = rank_assignm[i]
        while len(cur) < want:
            rank = next(it)
            if rank == local_rank:
                local_stage = i
            cur.append(rank)
    return local_stage

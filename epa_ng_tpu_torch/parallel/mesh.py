"""The fused placement step and its sharded multi-device form (the JAX
package's ``parallel/mesh.py``): preplace -> top-k select -> batched
Newton -> LWR -> on-device output filter, one call per query chunk.

On the card the Newton stage runs the CUDA kernel (``use_kernel``: f32
sliding mode, DNA or protein, with or without +I, and protein matrix
mixtures, whose query tips ``tQ`` carry RK per-category rows, through
:func:`_newton_blocked_kernel`);
f64, ``--pallas off`` and everything else take the torch Newton twin
(ops.newton).

Parallelization axes of the sharded step (:class:`ShardedPlacement`, the
CLI's ``--mesh DPxEP``), replacing the reference's MPI data parallelism +
OpenMP:

- ``dp``: queries are data-parallel (the reference's rank-sharded query
  streams, src/net/epa_mpi_util.cpp:10-30): each dp row of the mesh takes
  a contiguous slice of the chunk, and the rows never communicate;
- ``ep``: edges are model-parallel — the preplacement lookup table and the
  BLO store are split over the ep shards of a row, so a tree whose state
  exceeds one card's memory spreads over several.

A mesh (:func:`make_mesh`) is a placement map, a dp x ep grid of
``torch.device``: one process drives every shard, and the JAX package's
collectives over ep (an all-gather of the candidate lists, sums of the
softmax denominator and of the pair results) become copies to the dp
row's lead device (its ep shard 0) and a ``cat``, or a sum in shard
order, so the result is deterministic. A device may repeat in the grid:
then one card holds several shards, and everything but the copies between
distinct cards runs as it would across cards.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from epa_ng_tpu_torch.ops import newton
from epa_ng_tpu_torch.ops.blo_kernel import (
    PB, blo_optimize_batch_kernel, blo_optimize_batch_kernel_blocked,
    t_in_device_memory)
# one shared implementation of the preplacement contraction (the fused
# step and the exact path must rank candidates identically)
from epa_ng_tpu_torch.ops.lookup import preplace_scores_core as _preplace_scores
from epa_ng_tpu_torch.utils.timer import RECORDER


def _topk(scores, topk: int):
    """``jax.lax.top_k``: the k largest per row, ties in index order (a
    stable descending sort; ``torch.topk`` leaves tie order unspecified)."""
    idx = torch.argsort(scores, dim=1, descending=True, stable=True)[:, :topk]
    return torch.gather(scores, 1, idx), idx


def _select_topk(scores, threshold, topk: int, mode: str = "dynamic"):
    """Heuristic candidate cut within a static top-k budget: returns
    (top_edges [Q,k] int32, valid [Q,k] bool prefix mask, top_scores).

    - dynamic: valid marks the prefix kept by the accumulated-LWR rule
      (reference dynamic_heuristic, src/core/heuristics.hpp:66-88; same
      prefix-excludes-own-LWR convention as core.heuristics.candidate_mask).
      May saturate the budget (the engine re-runs those queries wider).
    - fixed: top ceil(threshold * E) edges; the engine sizes topk to
      exactly that count, so valid is all-ones (heuristics.hpp:90-99).
    - baseball: hits = edges within strike_box=3 logl of the best, keep
      min(hits + max_strikes=6, max_pitches=40) (heuristics.hpp:101-117).
    """
    top_scores, top_edges = _topk(scores, topk)               # [Q,k]
    denom = None
    if mode == "dynamic":
        ex = torch.exp(scores - top_scores[:, :1])
        denom = torch.sum(ex, dim=1)
    valid = _candidate_cut(top_scores, denom, threshold, topk, mode)
    return top_edges.to(torch.int32), valid, top_scores


def _candidate_cut(top_scores, denom, threshold, topk: int, mode: str):
    """valid [Q,k]: the prefix of the descending ``top_scores`` [Q,k] that
    the heuristic ``mode`` keeps (see :func:`_select_topk`); ``denom`` [Q]
    is the dynamic rule's softmax denominator over every edge,
    sum(exp(score - best))."""
    if mode == "dynamic":
        lwr_pre = (torch.exp(top_scores - top_scores[:, :1])
                   / denom[:, None])
        prefix = torch.cumsum(lwr_pre, dim=1) - lwr_pre
        return prefix < threshold                            # [Q,k]
    if mode == "fixed":
        return torch.ones(top_scores.shape, dtype=torch.bool,
                          device=top_scores.device)
    if mode == "baseball":
        strike_box, max_strikes, max_pitches = 3.0, 6, 40
        hits = torch.sum(top_scores >= top_scores[:, :1] - strike_box,
                         dim=1, keepdim=True)
        total = torch.clamp(hits + max_strikes, max=max_pitches)
        return torch.arange(topk, device=top_scores.device)[None, :] < total
    raise ValueError(f"unknown heuristic mode: {mode}")


def preplace_select(table, codes, begins, spans, threshold, topk: int):
    """Dispatch half of a two-phase fast path: preplacement scores + the
    dynamic heuristic's candidate cut on the device; returns (top_edges
    [Q, topk] int32, valid [Q, topk] bool), the candidate ids and mask that
    a host-side pair compaction would read. The engine runs the fused
    :func:`placement_step` instead; kept with the JAX package's."""
    scores = _preplace_scores(table, codes, begins, spans)
    top_edges, valid, _ = _select_topk(scores, threshold, topk)
    return top_edges, valid


def pair_windows(tU, tV, ls, lengths, tQ, invq, e_ids, q_ids, win_begin,
                 local_begin, spans, width: int):
    """Per-pair [width]-site windows starting at ``win_begin`` (begin +
    width <= S) for the twin/per-pair Newton: (tu, tv, tq, ls, mask,
    orig_len, invq), the mask covering [local_begin, local_begin + span)
    of each window."""
    dev = tU.device
    w = torch.arange(width, device=dev)
    idx = win_begin.long()[:, None] + w[None, :]              # [B, W]
    e = e_ids.long()
    q = q_ids.long()
    rk = torch.arange(tU.shape[1], device=dev)[None, :, None]
    kq = torch.arange(tQ.shape[1], device=dev)[None, :, None]
    tu = tU[e[:, None, None], rk, idx[:, None, :]]
    tv = tV[e[:, None, None], rk, idx[:, None, :]]
    tq = tQ[q[:, None, None], kq, idx[:, None, :]]
    lw = ls[e[:, None], idx]
    iv = invq[q[:, None], idx]
    mask = ((w[None, :] >= local_begin[:, None])
            & (w[None, :] < (local_begin + spans)[:, None])).to(tU.dtype)
    return tu, tv, tq, lw, mask, lengths[e], iv


def placement_step(consts: newton.EigConsts, table, tU, tV, ls, lengths,
                   codes, begins, spans, tQ, invq, prescoring_threshold,
                   topk: int = 8, sliding: bool = True,
                   site_width: int | None = None, packed: bool = False,
                   use_kernel: bool = False,
                   block_width: int | None = None,
                   phase1: int = 3,
                   filter_cfg: tuple | None = None,
                   filter_threshold=0.0,
                   heur_mode: str = "dynamic",
                   has_pinv: bool = False,
                   work=None):
    """One fused placement step over a query chunk.

    table: [E,C,S] preplacement lookup; tU, tV: [E,RK,S] eigen-transformed
    edge CLVs with combined log-scale ls: [E,S] (newton.transform_edges);
    codes: [Q,S]; tQ: [Q,K,S] eigen-transformed query tips
    (newton.transform_queries; [Q,RK,S] for a matrix mixture); invq:
    [Q,S] p-inv log term. Returns per
    query the top-k candidate (edges, logl, lwr, pendant, distal,
    valid-mask, computed-mask), all [Q,topk].

    ``site_width``: window width (>= every query's valid-range span) for the
    twin/per-pair Newton, which then computes only a per-query site window.
    ``use_kernel`` with ``block_width`` runs the CUDA kernel over the
    compacted live pairs (:func:`_newton_blocked_kernel`; ``block_width``
    bounds every pair's span and sizes the kernel's sumtable); without
    ``block_width`` it runs the kernel on pre-sliced windows.

    ``phase1``: two-phase convergence compaction (see
    :func:`_newton_blocked_kernel`). Restarting is trajectory-identical to
    one long run: the smoothing recursion is deterministic from the fixed
    init.

    ``has_pinv``: +I models; the kernel reads ``invq`` and ``ls``.
    ``work``: an ``ops.blo_kernel.NewtonWork`` to which the blocked kernel
    branch adds the work it executed, from the kernel's own counters, and
    the twin branch its calls of the torch twin.
    """
    dtype = tU.dtype
    scores = _preplace_scores(table, codes, begins, spans)

    # --- heuristic candidate selection within a static top-k
    top_edges, valid, _ = _select_topk(scores, prescoring_threshold, topk,
                                       heur_mode)

    # --- thorough placement on all (query, top-k edge) pairs
    Q = codes.shape[0]
    flat_e = top_edges.reshape(-1)
    q_ids = torch.arange(Q, device=tU.device).repeat_interleave(topk)

    if use_kernel and block_width is not None:
        logl, pendant, distal, computed = _newton_blocked_kernel(
            consts, tU, tV, ls, lengths, tQ, flat_e, q_ids,
            valid.reshape(-1), begins, spans, block_width,
            halve_budget=(heur_mode == "dynamic"), phase1=phase1,
            invq=invq, has_pinv=has_pinv, work=work)
        sh = (Q, topk)
        return _step_epilogue(top_edges, logl.reshape(sh),
                              pendant.reshape(sh), distal.reshape(sh), valid,
                              dtype, packed, computed=computed.reshape(sh),
                              filter_cfg=filter_cfg,
                              filter_threshold=filter_threshold,
                              dynamic_budget=(heur_mode == "dynamic"))

    S = tU.shape[2]
    W = S if site_width is None else min(site_width, S)
    win_begin = torch.clamp(begins, max=S - W)
    args = pair_windows(tU, tV, ls, lengths, tQ, invq, flat_e, q_ids,
                        win_begin[q_ids], (begins - win_begin)[q_ids],
                        spans[q_ids], W)
    computed = None
    if use_kernel:
        tu, tv, tq, lw, m, olen, iv = args
        logl, pendant, distal_rep, _, _, _ = blo_optimize_batch_kernel(
            consts, tu, tv, tq, lw, m, olen, iv, has_pinv=has_pinv)
    else:
        # two-phase convergence compaction, twin edition: the lock-step
        # smoothing loop runs until the SLOWEST pair of the batch
        # converges, so run everything with a tiny cap, then rerun only
        # the unconverged tail (compacted into a B/4 budget) with the full
        # budget.
        B = Q * topk
        max_sm = newton.SMOOTHINGS
        two_phase = bool(phase1) and phase1 < max_sm and B >= 256
        p1 = phase1 if two_phase else max_sm
        logl, pendant, distal_rep, _, _, done = newton.blo_optimize_batch(
            consts, *args, sliding=sliding, max_smoothings=p1)
        if work is not None:
            work.add_twin()
        if two_phase:
            flat_valid = valid.reshape(-1)
            unconv = flat_valid & ~done
            NB = min(B, max(B // 4, 128))
            ar = torch.arange(B, device=tU.device)
            key = torch.where(unconv, 0, B) + ar
            idx2 = torch.argsort(key, stable=True)[:NB]
            fits2 = unconv[idx2]
            args2 = tuple(a[idx2] for a in args)
            loglB, pendB, distB, _, _, _ = newton.blo_optimize_batch(
                consts, *args2, sliding=sliding, max_smoothings=max_sm)
            if work is not None:
                work.add_twin()
            put = lambda x, y: x.index_copy(0, idx2,
                                            torch.where(fits2, y, x[idx2]))
            logl, pendant = put(logl, loglB), put(pendant, pendB)
            distal_rep = put(distal_rep, distB)
            handled = torch.zeros(B, dtype=torch.bool, device=tU.device)
            handled = handled.index_copy(0, idx2, fits2)
            # a valid pair that neither converged in phase A nor fit the
            # phase-B budget is flagged uncomputed -> exact re-place
            computed = ((done | handled | ~flat_valid)
                        .to(dtype).reshape(Q, topk))

    sh = (Q, topk)
    return _step_epilogue(top_edges, logl.reshape(sh), pendant.reshape(sh),
                          distal_rep.reshape(sh), valid, dtype, packed,
                          computed=computed, filter_cfg=filter_cfg,
                          filter_threshold=filter_threshold,
                          dynamic_budget=(heur_mode == "dynamic"))


def _newton_blocked_kernel(consts, tU, tV, ls, lengths, tQ, flat_e, q_ids0,
                           live0, begins, spans, block_width: int,
                           halve_budget: bool, phase1: int,
                           invq=None, has_pinv: bool = False,
                           work=None):
    """Kernel Newton stage over a flat [B] (query, edge) pair list with
    in-dispatch candidate compaction (the JAX package's
    ``_newton_blocked_pallas``): live pairs sort to the front in begin
    order, dead pairs sink to the tail and become skipped lanes.

    ``live0`` marks pairs this dispatch must compute. Returns flat [B]
    (logl, pendant, distal, computed) — computed is 0 for dead or
    budget-dropped slots, whose results are garbage and must be discarded.

    ``halve_budget``: only the first half of the sorted pair list is
    dispatched under the dynamic heuristic (most of the static top-k
    budget is cut by the accumulated-LWR rule); a live pair beyond it is
    flagged uncomputed and its query re-runs through the engine's redo.

    The kernel reads every pair's own window, so a live pair whose span is
    within ``block_width`` always fits: the TPU kernel's shared 128-pair
    block window, and with it the site-window misfit, does not exist here.
    The computed/misfit plumbing stays so the engine's control flow is the
    JAX package's.

    ``phase1``: two-phase convergence compaction, kept from the TPU
    kernel's lock-step blocks: phase A runs everything with this small
    smoothing cap, then the unconverged pairs are compacted into an NP/4
    budget and rerun with the full cap (trajectory-identical to one long
    run).

    ``has_pinv``: the kernel adds each pair's invariant term
    exp(invq[q] - ls[e]) (both phases). ``work`` (``NewtonWork``)
    accumulates the pairs, smoothings and Newton iterations the kernel
    executed, from its counters (K5), on the device.
    """
    dtype = tU.dtype
    dev = tU.device
    S = tU.shape[2]
    B = flat_e.shape[0]
    if halve_budget:
        NP = max(PB, B // 2 // PB * PB)
    else:
        NP = -(-B // PB) * PB
    n_blocks = NP // PB
    Wb = block_width
    pb0 = begins[q_ids0].to(torch.int32)
    big = 1 << 24
    order_full = torch.argsort(torch.where(live0, 0, big) + pb0, stable=True)
    if NP <= B:
        order = order_full[:NP]
    else:
        order = torch.cat([order_full, order_full[-1:].repeat(NP - B)])

    flat_e_p = flat_e[order]
    q_ids_p = q_ids0[order]
    pb_p = pb0[order]
    sp_p = spans[q_ids_p].to(torch.int32)
    live_p = live0[order]
    if NP > B:
        live_p = live_p.clone()
        live_p[B:] = False

    fits = live_p & (sp_p <= Wb)
    block_active = torch.any(fits.reshape(n_blocks, PB), dim=1).to(
        torch.int32)
    orig_p = lengths[flat_e_p]
    site = torch.arange(S, device=dev)
    fullmask = ((site[None, :] >= pb_p[:, None])
                & (site[None, :] < (pb_p + sp_p)[:, None])).to(dtype)
    ls_sum = torch.sum(fullmask * ls[flat_e_p], dim=1)
    max_sm = newton.SMOOTHINGS
    two_phase = bool(phase1) and phase1 < max_sm and NP >= 4 * PB
    p1 = phase1 if two_phase else max_sm
    kw = dict(block_width=Wb, counters=work is not None)
    if has_pinv:
        kw.update(invq=invq, ls=ls)
    # the recorder's counts of this step's launches (host-side): all of
    # them, and those whose sumtable lives in device memory
    wide = t_in_device_memory(consts, Wb, has_pinv)
    launches = 1 + two_phase
    RECORDER.count("newton.launches", launches)
    RECORDER.count("newton.launches_wide", launches * wide)
    outA = blo_optimize_batch_kernel_blocked(
        consts, tU, tV, tQ, flat_e_p, q_ids_p, pb_p, sp_p, orig_p,
        ls_sum, max_smoothings=p1, skip=1.0 - fits.to(dtype),
        block_active=block_active, **kw)
    logl_s, pendant_s, distal_s, _, _, done_s = outA[:6]
    if work is not None:
        work.add(fits, outA[6:])
    computed_pair = fits
    if two_phase:
        # --- phase B: compact the unconverged tail into NP/4 pairs and
        # rerun with the full budget
        unconv = fits & ~done_s
        NB = (NP // 4) // PB * PB
        key = torch.where(unconv, 0, NP) + torch.arange(NP, device=dev)
        idx2 = torch.argsort(key, stable=True)[:NB]  # unconv first, in order
        fits2 = unconv[idx2]
        act2 = torch.any(fits2.reshape(NB // PB, PB), dim=1).to(torch.int32)
        outB = blo_optimize_batch_kernel_blocked(
            consts, tU, tV, tQ, flat_e_p[idx2], q_ids_p[idx2], pb_p[idx2],
            sp_p[idx2], orig_p[idx2], ls_sum[idx2],
            max_smoothings=max_sm, skip=1.0 - fits2.to(dtype),
            block_active=act2, **kw)
        loglB, pendB, distB = outB[:3]
        if work is not None:
            work.add(fits2, outB[6:])
        put = lambda x, y: x.index_copy(0, idx2,
                                        torch.where(fits2, y, x[idx2]))
        logl_s, pendant_s = put(logl_s, loglB), put(pendant_s, pendB)
        distal_s = put(distal_s, distB)
        handled = torch.zeros(NP, dtype=torch.bool, device=dev)
        handled = handled.index_copy(0, idx2, fits2)
        # phase-A stragglers that missed the phase-B budget re-place
        # exactly via the engine fallback
        computed_pair = fits & (done_s | handled)

    # scatter results back to [B] pair slots; slots never dispatched
    # (budget-halved tail) keep computed == 0 -> misfit redo
    m = min(NP, B)

    def unsort(x):
        out = torch.zeros(B, dtype=x.dtype, device=dev)
        return out.index_copy(0, order[:m], x[:m])

    return (unsort(logl_s), unsort(pendant_s), unsort(distal_s),
            unsort(computed_pair.to(dtype)))


def _step_epilogue(top_edges, logl, pendant, distal, valid, dtype,
                   packed: bool, computed=None, filter_cfg=None,
                   filter_threshold=0.0, dynamic_budget: bool = True):
    # --- LWR over the valid (and actually computed) candidates; a valid
    # pair the Newton stage did not compute must not poison the softmax —
    # its query is re-run by the engine
    if computed is None:
        computed = valid.to(dtype)
    ok = valid & (computed > 0)
    neg_inf = torch.tensor(-torch.inf, dtype=dtype, device=logl.device)
    masked_logl = torch.where(ok, logl, neg_inf)
    m = torch.amax(masked_logl, dim=1, keepdim=True)
    exl = torch.where(ok, torch.exp(masked_logl - m),
                      torch.zeros_like(masked_logl))
    lwr = exl / torch.sum(exl, dim=1, keepdim=True)

    if filter_cfg is not None:
        # --- output filtering ON DEVICE (the analog of
        # set_manipulators.cpp:131-204 run on the host per pquery): sort
        # each query's candidates by LWR desc, then keep a prefix count by
        # the min-LWR / accumulated-LWR rule, clamped to
        # [min(fmin, n_ok), min(fmax, n_ok)]. The host then only slices.
        acc, fmin, fmax = filter_cfg
        order = torch.argsort(-lwr, dim=1, stable=True)
        take = lambda x: torch.gather(x, 1, order)
        edges_s, logl_s, lwr_s = take(top_edges), take(logl), take(lwr)
        pend_s, dist_s, ok_s = take(pendant), take(distal), take(ok)
        okf = ok_s.to(dtype)
        if acc:
            prefix = torch.cumsum(lwr_s * okf, dim=1) - lwr_s * okf
            n_keep = torch.sum((prefix < filter_threshold) & ok_s, dim=1)
        else:
            n_keep = torch.sum((lwr_s > filter_threshold) & ok_s, dim=1)
        n_ok = torch.sum(ok_s, dim=1)
        n_keep = torch.minimum(torch.maximum(n_keep,
                                             torch.clamp(n_ok, max=fmin)),
                               torch.clamp(n_ok, max=fmax))
        rank = torch.cumsum(ok_s.to(torch.int32), dim=1) - 1
        keep = ok_s & (rank < n_keep[:, None])
        # an all-valid row only means "budget too small" under the
        # dynamic rule; fixed/baseball size the budget exactly
        if dynamic_budget:
            saturated = torch.all(valid, dim=1)
        else:
            saturated = torch.zeros(valid.shape[:1], dtype=torch.bool,
                                    device=valid.device)
        misfit = torch.any(valid & ~(computed > 0), dim=1)
        flags = (saturated.to(dtype) + 2.0 * misfit.to(dtype))[:, None]
        # at most filter_max rows survive per query and they sort to the
        # front — transfer only those columns to the host. At least one
        # column always ships: the engine reads flags from column 0.
        kf = max(1, min(keep.shape[1], int(fmax)))
        flags = flags.expand(keep.shape[0], kf)
        return torch.stack([edges_s[:, :kf].to(dtype), logl_s[:, :kf],
                            lwr_s[:, :kf], pend_s[:, :kf], dist_s[:, :kf],
                            keep[:, :kf].to(dtype), flags])

    if packed:
        # one [7, Q, topk] array => a single device->host transfer
        return torch.stack([top_edges.to(dtype), logl, lwr, pendant,
                            distal, valid.to(dtype), computed])
    return top_edges, logl, lwr, pendant, distal, valid, computed


def chunk_site_width(spans, num_sites: int) -> int:
    """Power-of-two window width covering every span in the chunk."""
    max_span = int(np.max(np.asarray(spans))) if len(spans) else num_sites
    w = 64
    while w < max_span:
        w *= 2
    return min(w, num_sites)


# --------------------------------------------------------------------------
# the multi-device half


class DeviceMesh:
    """A ``dp`` x ``ep`` grid of ``torch.device`` (``grid[i][j]`` holds ep
    shard j of dp row i) and its ``shape`` {"dp": ..., "ep": ...}, the
    JAX package's ``jax.sharding.Mesh`` axes."""

    def __init__(self, grid):
        self.grid = [[torch.device(d) for d in row] for row in grid]
        self.shape = {"dp": len(self.grid), "ep": len(self.grid[0])}


def make_mesh(n_dp: int, n_ep: int, devices=None) -> DeviceMesh:
    """A dp x ep mesh over the first ``n_dp * n_ep`` of ``devices`` (by
    default the local cards), row-major. A device may repeat: the list is
    a placement map, and a repeat is how one card stands in for several
    (the CLI alone asks for distinct cards)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_dp * n_ep > len(devices):
        raise ValueError(
            f"mesh {n_dp}x{n_ep} needs {n_dp * n_ep} devices, "
            f"have {len(devices)}")
    return DeviceMesh([devices[i * n_ep:(i + 1) * n_ep]
                       for i in range(n_dp)])


def _newton_twin_windowed_pairs(consts, tU, tV, ls, lengths, tQ, invq,
                                flat_e, q_ids0, live, begins, spans,
                                site_width, sliding: bool, phase1: int,
                                work=None):
    """Torch-twin Newton stage over a flat [B] pair list with per-pair site
    windows and two-phase convergence compaction (the JAX package's
    ``_newton_xla_windowed_pairs``): the sharded step's Newton wherever
    the kernel does not run (CPU, f64, ``--pallas off``, the twin routes).
    Same contract as :func:`_newton_blocked_kernel`: ``flat_e`` indexes
    THIS store, ``live`` marks the pairs to compute, and only slots with
    computed > 0 carry usable results."""
    dtype = tU.dtype
    S = tU.shape[2]
    B = flat_e.shape[0]
    W = S if site_width is None else min(site_width, S)
    win_begin = torch.clamp(begins, max=S - W)
    args = pair_windows(tU, tV, ls, lengths, tQ, invq, flat_e, q_ids0,
                        win_begin[q_ids0], (begins - win_begin)[q_ids0],
                        spans[q_ids0], W)
    max_sm = newton.SMOOTHINGS
    two_phase = bool(phase1) and phase1 < max_sm and B >= 256
    p1 = phase1 if two_phase else max_sm
    logl, pendant, distal_rep, _, _, done = newton.blo_optimize_batch(
        consts, *args, sliding=sliding, max_smoothings=p1)
    if work is not None:
        work.add_twin()
    computed = live
    if two_phase:
        unconv = live & ~done
        NB = min(B, max(B // 4, 128))
        key = torch.where(unconv, 0, B) + torch.arange(B, device=tU.device)
        idx2 = torch.argsort(key, stable=True)[:NB]
        fits2 = unconv[idx2]
        args2 = tuple(a[idx2] for a in args)
        loglB, pendB, distB, _, _, _ = newton.blo_optimize_batch(
            consts, *args2, sliding=sliding, max_smoothings=max_sm)
        if work is not None:
            work.add_twin()
        put = lambda x, y: x.index_copy(0, idx2,
                                        torch.where(fits2, y, x[idx2]))
        logl, pendant = put(logl, loglB), put(pendant, pendB)
        distal_rep = put(distal_rep, distB)
        handled = torch.zeros(B, dtype=torch.bool, device=tU.device)
        handled = handled.index_copy(0, idx2, fits2)
        computed = live & (done | handled)
    return logl, pendant, distal_rep, computed.to(dtype)


class _Shard(NamedTuple):
    """One ep shard's reference state on its device: the eigen constants
    (replicated) and its slice of the lookup table and of the BLO store."""
    device: torch.device
    consts: newton.EigConsts
    table: object           # [El, C, S] or a (resid, mean) pair
    tU: torch.Tensor
    tV: torch.Tensor
    ls: torch.Tensor
    lengths: torch.Tensor


def _spmd_step_body(shards, queries, threshold, filter_threshold, *,
                    topk: int, sliding: bool, site_width, use_kernel: bool,
                    block_width, phase1: int, filter_cfg, heur_mode: str,
                    packed: bool, has_pinv: bool = False, work=None):
    """The sharded placement step for one dp row of the mesh: ``shards``
    [n_ep] its ep shards (:class:`_Shard`), ``queries`` [n_ep] the row's
    query slice (codes, begins, spans, tQ, invq) on each shard's device.
    Every shard runs the single-device step's own functions on its local
    edge rows — the CUDA kernel included — in the JAX package's order:

    1. local preplacement scores and a local top-k, ids offset by j * El;
    2. the ep all-gather of the (score, id) lists, then the global top-k;
    3. the dynamic rule's softmax denominator, summed over the shards;
    4. the owner-partitioned Newton: the shard holding an edge's rows
       computes its pairs, on local edge ids; the others' lanes are dead;
    5. the sum of logl, pendant, distal and computed over the shards,
       each zeroed where its shard did not compute it;
    6. the same epilogue as :func:`placement_step`.

    The collectives are copies to the row's lead device (shard 0's) and a
    ``cat`` or a sum in shard order. Nothing here reads a result back to
    the host: the shards' work is all enqueued before the caller reads the
    output (the twin Newton syncs the host as it does on one device).
    Returns the epilogue's output on the lead device."""
    n_ep = len(shards)
    lead = shards[0].device
    dtype = shards[0].tU.dtype
    El = shards[0].tU.shape[0]        # local (ep-shard) edge rows
    Q = queries[0][0].shape[0]        # local (dp-row) query rows

    scores, ts_l, te_g = [], [], []
    for j, (sh, (codes, begins, spans, _, _)) in enumerate(
            zip(shards, queries)):
        sc = _preplace_scores(sh.table, codes, begins, spans)  # [Q, El]
        ts, te = _topk(sc, min(topk, El))
        scores.append(sc)
        ts_l.append(ts.to(lead))
        te_g.append((te.to(torch.int32) + j * El).to(lead))
    top_scores, sel = _topk(torch.cat(ts_l, dim=1), topk)
    top_edges = torch.gather(torch.cat(te_g, dim=1), 1, sel)

    denom = None
    if heur_mode == "dynamic":
        # the denominator sums over ALL edges: each shard its own rows
        m = top_scores[:, :1]
        for sc in scores:
            part = torch.sum(torch.exp(sc - m.to(sc.device)), dim=1).to(lead)
            denom = part if denom is None else denom + part
    valid = _candidate_cut(top_scores, denom, threshold, topk, heur_mode)

    flat_eg = top_edges.reshape(-1)
    flat_valid = valid.reshape(-1)
    parts = []
    for j, (sh, (codes, begins, spans, tQ, invq)) in enumerate(
            zip(shards, queries)):
        dev = sh.device
        eg = flat_eg.to(dev)
        mine = torch.div(eg, El, rounding_mode="floor") == j
        flat_e = torch.where(mine, eg - j * El, torch.zeros_like(eg))
        live = flat_valid.to(dev) & mine
        q_ids0 = torch.arange(Q, device=dev).repeat_interleave(topk)
        if use_kernel and block_width is not None:
            res = _newton_blocked_kernel(
                sh.consts, sh.tU, sh.tV, sh.ls, sh.lengths, tQ, flat_e,
                q_ids0, live, begins, spans, block_width,
                halve_budget=(heur_mode == "dynamic"), phase1=phase1,
                invq=invq, has_pinv=has_pinv, work=work)
        else:
            res = _newton_twin_windowed_pairs(
                sh.consts, sh.tU, sh.tV, sh.ls, sh.lengths, tQ, invq,
                flat_e, q_ids0, live, begins, spans, site_width, sliding,
                phase1, work=work)
        parts.append(res)

    if n_ep > 1:
        # every pair was computed on exactly one shard; non-computed slots
        # hold garbage (dead kernel lanes), so zero them before the sum
        total = None
        for logl, pendant, distal, computed in parts:
            ok = computed > 0
            vals = [torch.where(ok, x, torch.zeros_like(x)).to(lead)
                    for x in (logl, pendant, distal)]
            vals.append(computed.to(lead))
            total = vals if total is None else [
                a + b for a, b in zip(total, vals)]
        logl, pendant, distal, computed = total
    else:
        logl, pendant, distal, computed = parts[0]

    sh2 = (Q, topk)
    return _step_epilogue(
        top_edges, logl.reshape(sh2), pendant.reshape(sh2),
        distal.reshape(sh2), valid, dtype, packed,
        computed=computed.reshape(sh2), filter_cfg=filter_cfg,
        filter_threshold=filter_threshold,
        dynamic_budget=(heur_mode == "dynamic"))


class ShardedPlacement:
    """Places an engine's reference state on a (dp, ep) mesh and runs the
    fused placement step over it (:func:`_spmd_step_body` per dp row).

    The edge axis is padded to a multiple of ep (the edge count 2T-3 is
    odd): the pad rows of the table score -1e30 (a value that survives
    sums over sites without overflowing to -inf), so top-k never picks
    them, and the BLO store's pad rows repeat edge 0. Each ep slice of the
    table and the store goes to its shard's device (once per distinct
    device and slice, so a dp row on the same card shares it); the eigen
    constants are replicated. ``pad`` is the pad edge count. Queries are
    cut into dp contiguous slices, padded by the caller to a dp multiple
    (:meth:`preplace` pads itself); outputs are on the mesh's first device."""

    def __init__(self, engine, mesh: DeviceMesh, topk: int = 8):
        self.engine = engine
        self.mesh = mesh
        self.topk = topk
        self.num_edges = engine.num_edges
        blo = engine.blo
        n_ep = mesh.shape["ep"]
        E = blo.tU.shape[0]
        self.pad = pad = (-E) % n_ep
        El = (E + pad) // n_ep

        def pad_e(x, fill=None):
            if pad == 0:
                return x
            if fill is None:   # repeat edge 0 (never selected: table pad)
                tail = x[:1].expand((pad,) + tuple(x.shape[1:]))
            else:
                tail = torch.full((pad,) + tuple(x.shape[1:]), fill,
                                  dtype=x.dtype, device=x.device)
            return torch.cat([x, tail], dim=0)

        table = engine.lookup_table
        if isinstance(table, tuple):
            resid, mean = table
            table = (pad_e(resid, 0.0), pad_e(mean, -1e30))
        else:
            table = pad_e(table, -1e30)
        store = [pad_e(t) for t in (blo.tU, blo.tV, blo.ls, blo.lengths)]

        def part(x, j):
            return x[j * El:(j + 1) * El]

        consts, shards = {}, {}
        self.grid = []
        for row in mesh.grid:
            self.grid.append([])
            for j, dev in enumerate(row):
                if dev not in consts:
                    consts[dev] = newton.EigConsts(
                        *(t.to(dev) for t in engine.consts))
                if (dev, j) not in shards:
                    tbl = (tuple(part(t, j).to(dev).contiguous()
                                 for t in table)
                           if isinstance(table, tuple)
                           else part(table, j).to(dev).contiguous())
                    shards[dev, j] = _Shard(
                        dev, consts[dev], tbl,
                        *(part(t, j).to(dev).contiguous() for t in store))
                self.grid[-1].append(shards[dev, j])
        self._shards = list(shards.values())

    def shard_nbytes(self) -> list:
        """Per distinct (device, ep slice): the bytes its tensors hold."""
        out = []
        for sh in self._shards:
            tbl = sh.table if isinstance(sh.table, tuple) else (sh.table,)
            n = sum(t.nbytes for t in (*tbl, sh.tU, sh.tV, sh.ls,
                                       sh.lengths))
            out.append(dict(device=str(sh.device), edges=sh.tU.shape[0],
                            bytes=n))
        return out

    def _rows(self, *xs):
        """The dp rows' contiguous slices of the batch tensors ``xs``, each
        on every shard device of its row: [dp][ep] tuples."""
        dp = self.mesh.shape["dp"]
        Q = xs[0].shape[0]
        if Q % dp:
            raise ValueError(f"batch {Q} is not a multiple of dp={dp}")
        Qd = Q // dp
        return [[tuple(x[i * Qd:(i + 1) * Qd].to(sh.device) for x in xs)
                 for sh in row] for i, row in enumerate(self.grid)]

    def _run(self, codes, begins, spans, tQ, invq, threshold, **kw):
        out_dev = self.grid[0][0].device
        outs = [_spmd_step_body(row, q, threshold, **kw)
                for row, q in zip(self.grid,
                                  self._rows(codes, begins, spans, tQ,
                                             invq))]
        if kw["packed"] or kw["filter_cfg"] is not None:
            return torch.cat([o.to(out_dev) for o in outs], dim=1)
        return tuple(torch.cat([o[f].to(out_dev) for o in outs], dim=0)
                     for f in range(7))

    def step(self, codes, begins, spans, tQ, invq):
        """The plain sharded step (the unfiltered 7-tuple of
        :func:`placement_step`) at this placement's ``topk``."""
        opts = self.engine.options
        return self._run(
            codes, begins, spans, tQ, invq, opts.prescoring_threshold,
            filter_threshold=0.0, topk=self.topk, sliding=opts.sliding_blo,
            site_width=chunk_site_width(spans.cpu(),
                                        self.grid[0][0].tU.shape[2]),
            use_kernel=False, block_width=None, phase1=3, filter_cfg=None,
            heur_mode="dynamic", packed=False)

    def fused_step(self, codes, begins, spans, tQ, invq, *, topk: int,
                   sliding: bool, site_width: int, filter_cfg,
                   filter_threshold, heur_mode: str,
                   use_kernel: bool = False, block_width=None,
                   phase1: int = 3, has_pinv: bool = False, work=None):
        """The engine's full fused dispatch (packed + on-device filter)
        over the mesh — the sharded twin of the single-device call in
        PlacementEngine._dispatch_chunk_fused, running the same kernels on
        every shard."""
        return self._run(
            codes, begins, spans, tQ, invq,
            self.engine.options.prescoring_threshold,
            filter_threshold=filter_threshold, topk=topk, sliding=sliding,
            site_width=site_width, use_kernel=use_kernel,
            block_width=block_width, phase1=phase1, filter_cfg=filter_cfg,
            heur_mode=heur_mode, packed=True, has_pinv=has_pinv, work=work)

    def preplace(self, codes, begins, spans) -> np.ndarray:
        """[Q, E] preplacement scores against the ep-sharded table (the
        exact path's entry in mesh mode); pads the query batch to a dp
        multiple and drops the pad rows and edges."""
        from epa_ng_tpu_torch.core.engine import _HostCopy
        Q = codes.shape[0]
        dp = self.mesh.shape["dp"]
        Qp = -(-Q // dp) * dp
        if Qp != Q:
            rep = lambda x: torch.cat(
                [x, x[-1:].expand((Qp - Q,) + tuple(x.shape[1:]))])
            codes, begins, spans = rep(codes), rep(begins), rep(spans)
        pending = [[_HostCopy(_preplace_scores(sh.table, *q))
                    for sh, q in zip(row, qs)]
                   for row, qs in zip(self.grid,
                                      self._rows(codes, begins, spans))]
        scores = np.concatenate(
            [np.concatenate([h.numpy() for h in row], axis=1)
             for row in pending], axis=0)
        return scores[:Q, :self.num_edges]

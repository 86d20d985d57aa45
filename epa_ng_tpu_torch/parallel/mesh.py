"""The fused placement step (single-device half of the JAX package's
``parallel/mesh.py``): preplace -> top-k select -> batched Newton -> LWR ->
on-device output filter, one call per query chunk.

On the card the Newton stage runs the CUDA kernel (``use_kernel``: f32
sliding mode, DNA or protein, with or without +I, and protein matrix
mixtures, whose query tips ``tQ`` carry RK per-category rows, through
:func:`_newton_blocked_kernel`);
f64, ``--pallas off`` and everything else take the torch Newton twin
(ops.newton). The sharded multi-device step (``ShardedPlacement``,
``_spmd_step_body``, ``make_mesh``) is not ported yet; it extends this
module later.
"""

from __future__ import annotations

import numpy as np
import torch

from epa_ng_tpu_torch.ops import newton
from epa_ng_tpu_torch.ops.blo_kernel import (
    PB, blo_optimize_batch_kernel, blo_optimize_batch_kernel_blocked)
# one shared implementation of the preplacement contraction (the fused
# step and the exact path must rank candidates identically)
from epa_ng_tpu_torch.ops.lookup import preplace_scores_core as _preplace_scores


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
    if mode == "dynamic":
        ex = torch.exp(scores - top_scores[:, :1])
        denom = torch.sum(ex, dim=1, keepdim=True)
        lwr_pre = torch.exp(top_scores - top_scores[:, :1]) / denom
        prefix = torch.cumsum(lwr_pre, dim=1) - lwr_pre
        valid = prefix < threshold                           # [Q,k]
    elif mode == "fixed":
        valid = torch.ones(top_scores.shape, dtype=torch.bool,
                           device=scores.device)
    elif mode == "baseball":
        strike_box, max_strikes, max_pitches = 3.0, 6, 40
        hits = torch.sum(top_scores >= top_scores[:, :1] - strike_box,
                         dim=1, keepdim=True)
        total = torch.clamp(hits + max_strikes, max=max_pitches)
        valid = torch.arange(topk, device=scores.device)[None, :] < total
    else:
        raise ValueError(f"unknown heuristic mode: {mode}")
    return top_edges.to(torch.int32), valid, top_scores


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

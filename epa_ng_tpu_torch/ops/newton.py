"""Batched pplacer-style branch-length optimization: the eigenbasis
"sumtable" store and the torch Newton twin.

The reference's per-(query, edge) Newton-Raphson dance
(src/core/pll/optimize.cpp:60-248 ``opt_branch_lengths_pplacer``) runs as
one batched computation over a padded block of (query, edge) pairs:

- the edge CLVs are transformed into the substitution model's eigenbasis
  ONCE PER TREE (:func:`transform_edges` -> :class:`BloTensors`), query tips
  once per chunk (:func:`transform_queries`); every transition-matrix
  application along the trajectory is then an elementwise
  ``exp(lambda * rate * t)`` scaling,
- per-pair tensors are laid out SITE-LAST ([RK, W] / [K, W]),
- the outer smoothing loop (pendant NR -> constrained distal NR -> score,
  rollback on worse, converge at |dlogl| < 0.1) runs in lock step with
  per-pair active masks; each inner Newton solve clamps to
  [branch_min, branch_max].

:func:`blo_optimize_batch` is the f64 / non-kernel path (the CPU default).
The f32 hot path on the card is the CUDA kernel (ops.blo_kernel), whose
trilinear arithmetic differs from this module's sumtable form.

Semantics mirrored from the reference:
- initial lengths: pendant = -log(0.9), distal = proximal = original/2
  (src/core/pll/pll_util.cpp:354-386 ``reset_triplet_lengths``)
- pendant bounds [1e-6, 100] (PLLMOD_OPT_{MIN,MAX}_BRANCH_LEN)
- distal bounds [min(5e-7, orig/2), orig - tol] with proximal = orig - distal
  (optimize.cpp:171-210)
- rollback when new -logl worse than previous by > |new| * 1e-14
  (optimize.cpp:224-232); outer tolerance 0.1 (OPT_BRANCH_EPSILON)
- distal reported rescaled: orig/(distal+proximal) * distal
  (src/tree/Tiny_Tree.cpp:183-184)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BRLEN_MIN = 1e-6     # PLLMOD_OPT_MIN_BRANCH_LEN
BRLEN_MAX = 100.0    # PLLMOD_OPT_MAX_BRANCH_LEN
BRLEN_DEFAULT = 0.1  # PLLMOD_OPT_DEFAULT_BRANCH_LEN
DEFAULT_PENDANT = 0.10536051565782628  # -log(0.9)
OPT_BRANCH_EPSILON = 1e-1
MAX_ITERS = 30       # inner Newton iterations (optimize.cpp:62)
SMOOTHINGS = 32      # outer iterations (optimize.cpp:269)
# Inner-Newton flat-region stopping rules. Without them, pairs whose
# pendant optimum sits at t = infinity (a query unrelated to the edge)
# crawl along the flat exponential asymptote at a near-constant Newton
# step and exhaust MAX_ITERS; the reference's scalar loop pays the same
# crawl and accepts an equally arbitrary point (logl agrees to ~1e-8).
#
# GAIN_EPSILON: the Newton-decrement rule — at d2 < 0 the remaining
# objective gain to the local optimum is ~d1^2 / (2|d2|), so
# d1^2 <= GAIN_EPSILON * |d2| stops when at most ~0.005 logl remains,
# 10-20x under the smoothing epsilon (0.1).
# D1_EPSILON: absolute gradient floor for d2 >= 0 plateaus where the
# decrement is undefined.
GAIN_EPSILON = 1e-2
D1_EPSILON = 1e-4


class EigConsts(NamedTuple):
    """Per-model constants threaded through the kernels (device tensors).

    Matrix-mixture models (LG4M/LG4X) carry per-rate-category eigen
    systems: A/Ainv [R,K,K], eigenvals [R,K], freqs [R,K]; every function
    branches on A.ndim."""
    A: torch.Tensor         # [K,K] | [R,K,K]
    Ainv: torch.Tensor      # [K,K] | [R,K,K]
    eigenvals: torch.Tensor  # [K] | [R,K]
    rates: torch.Tensor     # [R]
    weights: torch.Tensor   # [R]
    freqs: torch.Tensor     # [K] | [R,K]
    pinv: torch.Tensor      # scalar


def eig_consts(eig, dtype=torch.float64, device="cuda") -> EigConsts:
    """EigConsts from an ops.eigen.EigenModel."""
    dev = torch.device(device)
    as_ = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    return EigConsts(A=as_(eig.A), Ainv=as_(eig.Ainv),
                     eigenvals=as_(eig.eigenvals), rates=as_(eig.rates),
                     weights=as_(eig.weights), freqs=as_(eig.freqs),
                     pinv=as_(eig.pinv))


class BloTensors(NamedTuple):
    """Eigen-transformed, scale-folded edge tensors: the device-resident
    "sumtable store" that the thorough-placement hot path reads."""
    tU: torch.Tensor       # [E, R*K, S] eigen-transformed rest-of-tree CLV
    tV: torch.Tensor       # [E, R*K, S] eigen-transformed subtree CLV,
    #                        scale-folded (carries exp(lsU+lsV - ls))
    ls: torch.Tensor       # [E, S] combined per-site log-scale (max over R)
    lengths: torch.Tensor  # [E]


def transform_edges(c: EigConsts, U, lsU, V, lsV, lengths,
                    site_map=None) -> BloTensors:
    """Build the BLO sumtable store from plain edge tensors
    (ops.clv.EdgeTensors layout: U, V [E,R,K,S]; lsU, lsV [E,R,S]).

    ``site_map``: [S_full] pattern index per original site when the edge
    tensors are pattern-compressed: the transform runs once per unique
    pattern, then gather-expands to full width (query tips differ at
    duplicated reference columns)."""
    E, R, K, S = U.shape
    lsr = lsU + lsV                                    # [E,R,S]
    ls = torch.amax(lsr, dim=1)                        # [E,S]
    Vs = V * torch.exp(lsr - ls[:, None, :])[:, :, None, :]
    if c.A.ndim == 3:
        tU = torch.einsum("rkj,erjs->erks", c.Ainv, U)
        tV = torch.einsum("rkj,erjs->erks", c.Ainv, Vs)
    else:
        tU = torch.einsum("kj,erjs->erks", c.Ainv, U)
        tV = torch.einsum("kj,erjs->erks", c.Ainv, Vs)
    tU = tU.reshape(E, R * K, S)
    tV = tV.reshape(E, R * K, S)
    if site_map is not None:
        site_map = torch.as_tensor(site_map, dtype=torch.long,
                                   device=U.device)
        tU = tU.index_select(2, site_map)
        tV = tV.index_select(2, site_map)
        ls = ls.index_select(1, site_map)
    return BloTensors(tU=tU.contiguous(), tV=tV.contiguous(),
                      ls=ls.contiguous(), lengths=lengths)


def transform_queries(c: EigConsts, qclv):
    """Eigen-transform query tip CLVs: qclv [Q,K,S] -> tQ [Q,K,S].

    Mixture models transform per category -> [Q,R*K,S]."""
    if c.A.ndim == 3:
        R, K, _ = c.A.shape
        tQ = torch.einsum("rkj,qjs->qrks", c.Ainv, qclv)
        return tQ.reshape(tQ.shape[0], R * K, tQ.shape[3])
    return torch.einsum("kj,qjs->qks", c.Ainv, qclv)


def _x_flat(c: EigConsts):
    """exp exponents per merged (rate, state): [R*K]."""
    ev = c.eigenvals if c.eigenvals.ndim == 2 else c.eigenvals[None, :]
    x = ev * c.rates[:, None] / (1.0 - c.pinv)
    return x.reshape(-1)


def _vec(x, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a scalar or [B] bound to a [B] tensor of ``like``'s type."""
    return torch.as_tensor(x, dtype=like.dtype,
                           device=like.device).expand(like.shape)


def cancelled(d1, x, lam_span):
    """The guarded snap: True where the Newton evaluation at ``x`` rests on
    a site likelihood that has cancelled, so a stop there must not be taken
    (NaN counts as cancelled). ``lam_span`` is max|x_j| (the fastest eigen
    rate) times the pair's span.

    A site likelihood f(t) ~ a + b t (a >= 0) near t = 0 adds at most ~2/t
    to dlogl/dt, and at least -max|x_j| anywhere; a solve stops only where
    d1 is balanced (a step under xtol, a small decrement) or points into a
    bound, which keeps |d1| * x well below 1 + max|x_j| * span * x. But f
    near t = 0 is a sum of eigenbasis terms up to 1e8 times larger than f,
    and in f32 it cancels to noise (tiny, zero or negative and clamped to
    FLT_MIN): d1 and d2 explode by orders of magnitude, the step falls
    under xtol, the solve stops at or just above the lower bound, and the
    smoothing then rolls the pair back to its initial lengths (the stall);
    or, cancelled by less, the step crawls at a tenth of x, spends the
    solve's iterations and leaves the length short. The test flags some
    sound evaluations near the bound too (|d1| * x up to ~2 a dominated
    site); the Newton acts on it only at a stop or a crawl, which sound
    evaluations do not make there. f64 cancels far more rarely (a K = 20
    site at 1e-11 of its terms), and the guard repairs the same stall
    there."""
    return ~(torch.abs(d1) * x <= 1.0 + lam_span * x)


def _newton(c: EigConsts, T, pinv_lin, site_mask, xmin, xmax, xtol, xguess):
    """Maximize logl(t) = sum_s m_s log((1-p) f_s(t) + pinv_lin_s) per pair,
    f_s(t) = sum_j T[j,s] exp(x_j t); safeguarded Newton on dlogl/dt.
    T: [B, R*K, W] sumtables; bounds scalar or [B]; xguess [B].

    Guarded snap: a stop whose evaluation has cancelled (:func:`cancelled`)
    is not taken; the iterate backs off halfway to ``x_hi``, the last point
    evaluated soundly with d1 < 0 (the guess to start), and goes on. Nor is
    such an evaluation's crawling step (d1 > 0, d2 < 0, under x / 8, where
    a sound evaluation near the bound steps at least x): x doubles."""
    x_j = _x_flat(c)                                  # [RK]
    lam_span = torch.abs(x_j).max() * site_mask.sum(-1)
    omp = 1.0 - c.pinv
    tiny = torch.finfo(T.dtype).tiny
    xmin, xmax = _vec(xmin, xguess), _vec(xmax, xguess)
    xtol = _vec(xtol, xguess)

    def derivs(t):
        E = torch.exp(x_j[None, :] * t[:, None])      # [B, RK]
        f0 = torch.einsum("bjs,bj->bs", T, E)
        f1 = torch.einsum("bjs,bj->bs", T, E * x_j)
        f2 = torch.einsum("bjs,bj->bs", T, E * x_j * x_j)
        g = torch.clamp(omp * f0 + pinv_lin, min=tiny)
        r1 = omp * f1 / g
        d1 = torch.sum(site_mask * r1, dim=-1)
        d2 = torch.sum(site_mask * (omp * f2 / g - r1 * r1), dim=-1)
        return d1, d2

    x = torch.minimum(torch.maximum(xguess, xmin), xmax)
    x_hi = x
    done = torch.zeros_like(x, dtype=torch.bool)
    slid = torch.zeros_like(x)
    one = torch.ones_like(x)
    for _ in range(MAX_ITERS):
        if bool(done.all()):   # done pairs are frozen: exiting is exact
            break
        d1, d2 = derivs(x)
        newton_x = x - d1 / torch.where(d2 == 0, one, d2)
        # proper maximum requires d2 < 0; otherwise slide toward the bound
        # in the uphill direction. A SECOND consecutive slide in the same
        # direction snaps straight TO the bound (same rule as the kernel).
        dirn = torch.where(d1 > 0, one, -one)
        snap = (d2 >= 0) & (slid * dirn > 0)
        bound = torch.where(d1 > 0, xmax, xmin)
        slide = torch.where(snap, bound,
                            torch.where(d1 > 0, (x + xmax) / 2,
                                        (x + xmin) / 2))
        xnew = torch.where(d2 < 0, newton_x, slide)
        xnew = torch.minimum(torch.maximum(xnew, xmin), xmax)
        slid = torch.where(d2 < 0, torch.zeros_like(slid), dirn)
        converged = ((torch.abs(xnew - x) < xtol)
                     | (torch.abs(d1) <= D1_EPSILON)
                     | ((d2 < 0) & (d1 * d1 <= GAIN_EPSILON * -d2)))
        bad = cancelled(d1, x, lam_span)
        crawl = (bad & ~converged & (d1 > 0) & (d2 < 0)
                 & (xnew - x < x * 0.125))
        xnew = torch.where(crawl, torch.minimum(x + x, xmax), xnew)
        slid = torch.where(crawl, torch.zeros_like(slid), slid)
        back = converged & bad & (x < x_hi)
        converged = converged & ~back
        xnew = torch.where(back, (x_hi + x) * 0.5, xnew)
        slid = torch.where(back, torch.zeros_like(slid), slid)
        x_hi = torch.where(~done & ~bad & (d1 < 0), x, x_hi)
        x = torch.where(done, x, xnew)
        done = done | converged
    return x


def _apply_p(c: EigConsts, tX, t):
    """Propagate eigen-space CLVs through P(t) back to the normal basis.
    tX: [B, R*K, W], t: [B] -> [B, R, K(i), W]."""
    B, RK, W = tX.shape
    K = c.A.shape[-1]
    R = RK // K
    e = torch.exp(_x_flat(c)[None, :] * t[:, None])   # [B, RK]
    Y = (tX * e[:, :, None]).reshape(B, R, K, W)
    if c.A.ndim == 3:
        return torch.einsum("rik,brks->bris", c.A, Y)
    return torch.einsum("ik,brks->bris", c.A, Y)


def _q_rk(c: EigConsts, tQ):
    """Broadcast [B, K, W] eigen query tips over rate categories:
    [B, R*K, W]. Mixture-model query tips arrive already per-category."""
    R = c.rates.shape[0]
    K = c.A.shape[-1]
    if tQ.shape[1] == R * K:
        return tQ
    B, _, W = tQ.shape
    return tQ[:, None].expand(B, R, K, W).reshape(B, R * K, W)


def _logl(c: EigConsts, inner, tQ, pendant, pinv_lin, site_mask, ls):
    """Edge logl between the inner CLVs (normal basis, [B,R,K,W]) and the
    query tips (eigen basis) at the given pendant lengths [B]."""
    Mq = _apply_p(c, _q_rk(c, tQ), pendant)           # [B,R,K,W]
    if c.freqs.ndim == 2:
        f = torch.einsum("bris,bris,ri,r->bs", inner, Mq, c.freqs, c.weights)
    else:
        f = torch.einsum("bris,bris,i,r->bs", inner, Mq, c.freqs, c.weights)
    g = (1.0 - c.pinv) * f + pinv_lin
    g = torch.clamp(g, min=torch.finfo(g.dtype).tiny)
    return torch.sum(site_mask * (torch.log(g) + ls), dim=-1)


def _sumtable(c: EigConsts, part, other):
    """Sumtables between normal-basis partials ([B,R,K,W]) and eigen-basis
    CLVs ([B, R*K, W]): T[b, j=r*K+k, s]."""
    B, R, K, W = part.shape
    if c.A.ndim == 3:
        piA = c.A * c.freqs[:, :, None]               # [R, K(i), K(k)]
        a = torch.einsum("bris,rik->brks", part, piA)
    else:
        piA = c.A * c.freqs[:, None]                  # [K(i), K(k)]
        a = torch.einsum("bris,ik->brks", part, piA)
    T = c.weights[None, :, None, None] * a * other.reshape(B, R, K, W)
    return T.reshape(B, R * K, W)


def _smooth_step(c: EigConsts, tU, tV, tQ, ls, pinv_lin, site_mask,
                 orig_len, pendant, distal, proximal, neg_logl):
    """One smoothing (pendant NR -> constrained distal NR -> rescore) for
    pairs that are still running; returns the new state and done flags."""
    dist_min = torch.clamp(orig_len / 2.0, max=BRLEN_MIN / 2.0)
    dist_tol = dist_min / 10.0
    dist_max = orig_len - dist_tol
    tQrk = _q_rk(c, tQ)

    MU = _apply_p(c, tU, proximal)
    MV = _apply_p(c, tV, distal)
    inner = MU * MV                                   # [B,R,K,W]

    # --- pendant NR: sumtable between inner CLV and query tip
    T1 = _sumtable(c, inner, tQrk)
    guess = torch.where((pendant < BRLEN_MIN) | (pendant > BRLEN_MAX),
                        torch.full_like(pendant, BRLEN_DEFAULT), pendant)
    new_pendant = _newton(c, T1, pinv_lin, site_mask,
                          BRLEN_MIN, BRLEN_MAX, BRLEN_MIN / 10.0, guess)

    # --- distal NR (constrained: proximal = orig - distal)
    Mq = _apply_p(c, tQrk, new_pendant)
    T2 = _sumtable(c, Mq * MU, tV)
    guess2 = torch.where((distal < dist_min) | (distal > dist_max),
                         orig_len / 2.0, distal)
    new_distal = _newton(c, T2, pinv_lin, site_mask,
                         dist_min, dist_max, dist_tol, guess2)
    new_proximal = orig_len - new_distal

    MU2 = _apply_p(c, tU, new_proximal)
    MV2 = _apply_p(c, tV, new_distal)
    new_neg = -_logl(c, MU2 * MV2, tQ, new_pendant, pinv_lin, site_mask, ls)

    worse = (new_neg - neg_logl) > torch.abs(new_neg) * 1e-14
    converged = torch.abs(new_neg - neg_logl) < OPT_BRANCH_EPSILON
    # rollback keeps old lengths; otherwise accept
    pick = lambda old, new: torch.where(worse, old, new)
    return (pick(pendant, new_pendant), pick(distal, new_distal),
            pick(proximal, new_proximal), pick(neg_logl, new_neg),
            worse | converged)


def _raxml_step(c: EigConsts, tU, tV, tQ, ls, pinv_lin, site_mask,
                orig_len, pendant, distal, proximal, neg_logl):
    """One smoothing of ``--raxml-blo`` for pairs that are still running:
    NR on the pendant, then the distal, then the proximal length, each
    independently in [BRLEN_MIN, BRLEN_MAX] with no sum constraint (like
    pllmod_opt_optimize_branch_lengths_local with radius 1), each solve on
    the lengths the previous ones left; then rescore, with the sliding
    step's rollback and stop."""
    tQrk = _q_rk(c, tQ)

    def nr_branch(T, guess):
        g = torch.where((guess < BRLEN_MIN) | (guess > BRLEN_MAX),
                        torch.full_like(guess, BRLEN_DEFAULT), guess)
        return _newton(c, T, pinv_lin, site_mask, BRLEN_MIN, BRLEN_MAX,
                       BRLEN_MIN / 10.0, g)

    MU = _apply_p(c, tU, proximal)
    MV = _apply_p(c, tV, distal)
    new_pendant = nr_branch(_sumtable(c, MU * MV, tQrk), pendant)
    Mq = _apply_p(c, tQrk, new_pendant)
    new_distal = nr_branch(_sumtable(c, Mq * MU, tV), distal)
    MV2 = _apply_p(c, tV, new_distal)
    new_proximal = nr_branch(_sumtable(c, Mq * MV2, tU), proximal)

    MU2 = _apply_p(c, tU, new_proximal)
    new_neg = -_logl(c, MU2 * MV2, tQ, new_pendant, pinv_lin, site_mask, ls)
    worse = (new_neg - neg_logl) > torch.abs(new_neg) * 1e-14
    converged = torch.abs(new_neg - neg_logl) < OPT_BRANCH_EPSILON
    pick = lambda old, new: torch.where(worse, old, new)
    return (pick(pendant, new_pendant), pick(distal, new_distal),
            pick(proximal, new_proximal), pick(neg_logl, new_neg),
            worse | converged)


def _optimize_batch(c: EigConsts, tU, tV, tQ, ls, pinv_lin, site_mask,
                    orig_len, max_smoothings: int = SMOOTHINGS,
                    sliding: bool = True):
    """Optimize a batch of (query, edge) pairs. tU, tV: [B, R*K, W]
    eigen-transformed edge CLVs (tV scale-folded); tQ: [B, K, W]; ls,
    pinv_lin, site_mask: [B, W]; orig_len: [B]. Returns (logl, pendant,
    distal, proximal, done), each [B].

    ``sliding``: the pplacer smoothing (:func:`_smooth_step`), else the
    independent ``--raxml-blo`` one (:func:`_raxml_step`). The JAX package
    vmaps a per-pair ``while_loop``; here the smoothing loop runs over the
    still-active subset, which gives the same per-pair trajectories (a
    pair's state never depends on another pair's)."""
    step = _smooth_step if sliding else _raxml_step
    half = orig_len / 2.0
    pendant = torch.full_like(orig_len, DEFAULT_PENDANT)
    distal, proximal = half.clone(), half.clone()
    MU = _apply_p(c, tU, proximal)
    MV = _apply_p(c, tV, distal)
    neg = -_logl(c, MU * MV, tQ, pendant, pinv_lin, site_mask, ls)
    done = torch.zeros_like(orig_len, dtype=torch.bool)
    for _ in range(max_smoothings):
        act = torch.nonzero(~done).flatten()
        if act.numel() == 0:
            break
        sub = lambda x: x.index_select(0, act)
        p, d, pr, n, dn = step(
            c, sub(tU), sub(tV), sub(tQ), sub(ls), sub(pinv_lin),
            sub(site_mask), sub(orig_len), sub(pendant), sub(distal),
            sub(proximal), sub(neg))
        pendant = pendant.index_copy(0, act, p)
        distal = distal.index_copy(0, act, d)
        proximal = proximal.index_copy(0, act, pr)
        neg = neg.index_copy(0, act, n)
        done = done.index_copy(0, act, dn)
    return -neg, pendant, distal, proximal, done


def blo_optimize_batch(c: EigConsts, tU, tV, tQ, ls, site_mask, orig_len,
                       inv_logfreq, sliding: bool = True,
                       max_smoothings: int = SMOOTHINGS):
    """Batched thorough placement over a padded pair block: the pplacer
    sliding smoothing, or with ``sliding=False`` the independent
    ``--raxml-blo`` one (JAX ``_optimize_one_raxml``).

    tU, tV: [B, R*K, W] eigen-transformed per-pair edge CLV windows (tV
    scale-folded; see transform_edges); tQ: [B, K, W] eigen-transformed
    query tips (transform_queries); ls: [B, W] combined log-scale;
    site_mask: [B, W]; orig_len: [B]; inv_logfreq: [B, W] log(pinv*pi_inv)
    with -inf at non-invariant sites (or all -inf when pinv == 0).

    Returns (logl, pendant, distal_reported, distal_raw, proximal_raw,
    done): the reported distal is rescaled to the original branch length
    like the reference (Tiny_Tree.cpp:183-184).
    """
    # linear-space invariant term, counteracting the CLV scaling
    pinv_lin = torch.exp(inv_logfreq - ls) * site_mask
    logl, pendant, distal, proximal, done = _optimize_batch(
        c, tU, tV, tQ, ls, pinv_lin, site_mask, orig_len, max_smoothings,
        sliding)
    distal_rep = (orig_len / (distal + proximal)) * distal
    return logl, pendant, distal_rep, distal, proximal, done

"""The thorough-placement Newton kernel: CUDA launch, plain PyTorch version,
and the two wrappers the engine calls.

Counterpart of ``epa_ng_tpu/ops/pallas_blo.py``. All five TPU kernels —
K1 (``_blo_kernel_blocked``), K3 (``_blo_kernel``), their +I variants K2
(``_blo_kernel_blocked_pinv``) and K4 (``_blo_kernel_pinv``), and the
iteration-counting K5 (``_blo_kernel_counted``) — become ONE CUDA kernel,
``csrc/blo_newton.cu``, that reads each (query, edge) pair's own site
window out of the full site-last stores by edge and query id. +I is a
template flag (built as a second library), the counters an optional
output. It is instantiated for DNA (K = 4) and protein (K = 20), and at
K = 20 for matrix mixtures (LG4M/LG4X: per-rate coefficient tables and a
per-category query tip), as ``_blo_compute`` is, at 1 to
:data:`MAX_RATES` rate categories (past 8: the K = 4 runtime-R
instantiation; at K = 20 a thread-block cluster of ceil(R / 8) CTAs a
pair, each holding 8 of the rates). Its Newton solves
carry the guarded snap (``ops.newton.cancelled``), which the TPU kernel
lacks. Its interface is :data:`blo_newton`:

    tU, tV [E, RK, S], tQ [Q, Kq, S]     full stores (f32, contiguous);
                                         Kq = K, or RK for a mixture
    e_ids, q_ids, begins, spans [P]      per-pair rows and site windows
    orig_len, skip [P]                   edge lengths, dead-lane flags
    _kernel_scalars tables               x_rk [RK], wA [RK,K], A, piA [K,K]
                                         (a mixture's A, piA [RK,K])
    invq [Q, S], ls [E, S], omp          +I only: the invariant term
                                         exp(invq[q] - ls[e]), 1 - pinv
    -> logl (scaled space), pendant, distal, proximal, done   each [P]
       (+ smoothings, newton_iters [P] int32 with ``counters``)

:func:`blo_newton_plain` is the plain batched-torch version of the same
function: it repeats ``_blo_compute``'s arithmetic (eigen back-transform,
``piA`` contraction, Newton with slide/snap and flat-region stops,
rollback, the +I term) on gathered windows. CPU tensors go to it; CUDA
tensors go to the kernel or raise — nothing falls back.

Wrappers with the JAX package's call shapes:

- :func:`blo_optimize_batch_kernel_blocked` — ``blo_optimize_batch_pallas_
  blocked``'s outputs and scalar arguments, with the gathered tUg/tVg/tQg
  (and the +I ``pinv_lin`` [NP, S]) replaced by the full stores plus
  ``e_ids``/``q_ids`` and the per-block ``mask``/``offs`` replaced by the
  per-pair ``begins``/``spans`` the kernel reads (the fused step and the
  exact path; K1, K2);
- :func:`blo_optimize_batch_kernel` — ``blo_optimize_batch_pallas``'s
  signature on pre-sliced per-pair windows (``placement_step`` without a
  ``block_width``; K3, K4).

Both take ``counters`` (K5's executed smoothings and Newton iterations,
per pair). The kernel takes a window of any width: its sumtable sits in
shared memory up to :func:`max_shared_sites` and in device memory beyond,
so the engine never needs the TPU path's windowed fallbacks. Each pair runs
on a team of threads in one persistent CTA, ``DNA_TEAM`` at K = 4 and
``WIDE_TEAM`` at K = 20 (:func:`kernel_geometry`), or past 8 rates at
K = 20 on a cluster of such CTAs (:func:`cluster_ctas`).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from epa_ng_tpu_torch.ops.newton import (BRLEN_DEFAULT, BRLEN_MAX, BRLEN_MIN,
                                         D1_EPSILON, DEFAULT_PENDANT,
                                         GAIN_EPSILON, MAX_ITERS,
                                         OPT_BRANCH_EPSILON, SMOOTHINGS,
                                         cancelled)

K_STATES = (4, 20)  # DNA and protein instantiations of the kernel
# K = 4 rate counts with a compile-time instantiation (csrc/blo_newton.cu
# MAX_R); more rates take the runtime-R one
STATIC_RATES = 8
PB = 128            # pair-padding granule of the engine's control flow
# threads per pair, one persistent CTA each (csrc/blo_newton.cu DNA_TEAM,
# TEAM): K = 4 and K = 20. A CTA keeps one pair's sumtable T ([RK (+1),
# width] f32) in shared memory where it fits beside the CTA's tables,
# exponential rows and reduction buffers (227 KB usable per block), and in
# a device-memory scratch of at most T_SCRATCH_BYTES beyond, one slice per
# CTA. At K = 20 one barrier publishes the partial sums of RED_UNITS
# (site, rate) units; past CLUSTER_RATES rates a pair runs on a cluster of
# up to MAX_CLUSTER CTAs (csrc/blo_newton.cu MAX_CLUSTER, the most a
# portable cluster holds), CLUSTER_RATES rates each, one a warp.
DNA_TEAM = 128
WIDE_TEAM = 256
RED_UNITS = 512
CLUSTER_RATES = WIDE_TEAM // 32
MAX_CLUSTER = 8
# the JAX package's Pallas budget (epa_ng_tpu/ops/pallas_blo.py
# MAX_RK_SITES): it runs its XLA twin where R K x 32 sites exceed it
MAX_RK_SITES = 24576
SMEM_PER_BLOCK = 227 * 1024
SMEM_PER_SM = 228 * 1024      # of which the runtime keeps 1 KB per block
T_SCRATCH_BYTES = 256 << 20
SM_REGISTERS = 65536
MAX_CTAS_PER_SM = 32
MAX_THREADS_PER_SM = 2048

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "blo_newton.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build")


def _round32(n: int) -> int:
    return -(-n // 32) * 32


def _tab_bytes(k: int, r: int, mixture: bool = False) -> int:
    """Bytes of the scalar tables at the head of the kernel's shared memory,
    as csrc/blo_newton.cu lays them out: at K = 4 x_rk, wA, A, piA and
    x_rk^2, 24 R + 32 floats rounded up to 32, and never fewer than R = 8's
    224 (TAB_FLOATS, every compile-time instantiation; ``dna_tab_floats``);
    at K = 20 x_rk, wA and A, piA ([K, K], or [RK, K] for a mixture),
    rounded up to 32 floats (``wide_tab_floats``)."""
    if k == 4:
        return max(224, _round32(24 * r + 32)) * 4
    rk = r * k
    floats = rk + rk * k + (2 * rk * k if mixture else 2 * k * k)
    return _round32(floats) * 4


def _team(k: int) -> int:
    """Threads per pair (one CTA) at ``k`` states."""
    return DNA_TEAM if k == 4 else WIDE_TEAM


def cluster_ctas(k: int, r: int) -> int:
    """CTAs a pair runs on: one, or at K = 20 past CLUSTER_RATES rates a
    cluster of ceil(R / CLUSTER_RATES), CTA c holding the rates
    [8c, min(8c + 8, R)) (``cluster_ctas``)."""
    return 1 if k == 4 else -(-r // CLUSTER_RATES)


def _slice_rates(k: int, r: int) -> int:
    """The rate slots one CTA's layout holds: R, or CLUSTER_RATES in each
    CTA of a cluster (``slice_rates``)."""
    return r if k == 4 else min(r, CLUSTER_RATES)


def _exp_bytes(k: int, r: int = 1) -> int:
    """Shared memory of a CTA for its exponential rows e^{x t}, two per
    warp: at K = 4 the RK exponentials, 32 floats (RK rounded up to 32
    past 8 rates, each lane filling every 32nd entry); at K = 20 the 20 of
    the warp's rate in 32 floats."""
    row = max(32, _round32(4 * r)) if k == 4 else 32
    return _team(k) // 32 * 2 * row * 4


def _red_bytes(k: int) -> int:
    """Shared memory of a CTA for its reductions: warp slots [2][2][warps]
    (at K = 4 then two ints, the next pair's index, and max |x_rk|;
    rounded up to 32 floats) and, at K = 20, per-unit partial sums
    [2][3][RED_UNITS]."""
    if k == 4:
        return _round32(4 * DNA_TEAM // 32 + 3) * 4
    return (6 * RED_UNITS + _round32(4 * WIDE_TEAM // 32)) * 4


def _t_stride(k: int, rk: int, has_pinv: bool = False) -> int:
    """Floats of T per site (csrc/blo_newton.cu): at K = 20 its rows (RK,
    +1 with +I; T is [rows][width]); at K = 4, where T is site-major
    ([width][stride]), the rows padded to 4 mod 8 (``dna_t_stride``)."""
    rows = rk + has_pinv
    if k != 4:
        return rows
    padded = -(-rows // 4) * 4
    return padded + 4 if padded % 8 == 0 else padded


def _t_sites(k: int, width: int) -> int:
    """Sites of T at sumtable width ``width``: at K = 4 the width rounded
    up to 32 (``dna_t_sites``: the runtime-R loops write T up to the span
    rounded up to a warp's 32 sites), at K = 20 the width."""
    return _round32(width) if k == 4 else width


def _team_fixed_bytes(k: int, R: int, mixture: bool) -> int:
    """A CTA's shared memory ahead of T: tables, exponential rows,
    reduction buffers (at K = 20 for its slice of the rates)."""
    s = _slice_rates(k, R)
    return _tab_bytes(k, s, mixture) + _exp_bytes(k, s) + _red_bytes(k)


def max_rates(num_states: int, mixture: bool = False) -> int:
    """The most rate categories the kernel takes at ``num_states`` (and
    for a matrix mixture; csrc/blo_newton.cu ``blo_newton_team`` refuses
    past it): at K = 4 the largest R whose tables, exponential rows and
    reduction buffers fit shared memory beside one 32-site tile of T with
    the +I row, 312; at K = 20 CLUSTER_RATES rates in each of MAX_CLUSTER
    CTAs, 64, a single matrix or a mixture."""
    if num_states != 4:
        return CLUSTER_RATES * MAX_CLUSTER
    fits = lambda r: (_team_fixed_bytes(num_states, r, mixture)
                      + _round32(_t_stride(num_states, num_states * r, True)
                                 * 32) * 4 <= SMEM_PER_BLOCK)
    r = 1
    while fits(r + 1):
        r += 1
    return r


# the rate cap per (state count, mixture)
MAX_RATES = {(k, m): max_rates(k, m) for k, m in ((4, False), (20, False),
                                                  (20, True))}


def kernel_geometry(num_states: int, R: int, width: int,
                    mixture: bool = False, has_pinv: bool = False,
                    regs: int = 255) -> dict:
    """The kernel's geometry at ``num_states`` (4 or 20) and R rate
    categories for sumtable width ``width``, as csrc/blo_newton.cu
    (``TeamLayout``, ``launch_dna``, ``launch_team``) sets it up:
    ``threads`` per CTA, ``cluster`` CTAs per pair (past 8 rates at K = 20,
    each holding ``slice_rates`` rate slots), ``tile`` (thread t owns
    sites t, t + tile, ...; at K = 20 of its rate), ``t_shared`` (T in
    shared memory; else in the device-memory scratch) and ``shared_bytes``
    of a CTA; and ``ctas_per_sm`` and ``warps_per_sm`` as the runtime's
    occupancy gives them for ``regs`` registers a thread (the count ptxas
    gave the instantiation, which :meth:`_BloNewton.team_geometry` reads
    back; 255, the most a thread may hold, by default): registers go to
    warps in units of 256 within each of an SM's four partitions, and each
    CTA's shared memory costs 1 KB more."""
    threads = _team(num_states)
    warps = threads // 32
    s = _slice_rates(num_states, R)
    fixed = _team_fixed_bytes(num_states, R, mixture)
    t = _round32(_t_stride(num_states, num_states * s, has_pinv)
                 * _t_sites(num_states, width)) * 4
    t_shared = fixed + t <= SMEM_PER_BLOCK
    shared = fixed + t * t_shared
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = SM_REGISTERS // 4 // per_warp * 4 // warps
    ctas = min(MAX_THREADS_PER_SM // threads, MAX_CTAS_PER_SM, by_regs,
               SMEM_PER_SM // (shared + 1024))
    tile = threads if num_states == 4 else 32 * max(1, warps // R)
    return dict(threads=threads, cluster=cluster_ctas(num_states, R),
                slice_rates=s, tile=tile, t_shared=t_shared,
                shared_bytes=shared, regs=regs, ctas_per_sm=ctas,
                warps_per_sm=ctas * warps)


def max_shared_sites(rk: int, has_pinv: bool = False, num_states: int = 4,
                     mixture: bool = False) -> int:
    """Widest window whose sumtable the kernel keeps in shared memory; wider
    windows keep it in device memory: one pair's T (at K = 20 past 8 rates
    a cluster CTA's rows of it) beside the CTA's tables, exponential rows
    and reduction buffers. +I adds one row (pv) to the sumtable. K = 4:
    2880 sites at RK = 16, with or without +I (20 floats a site). K = 20:
    640 sites at RK = 80, with or without +I (608 for a mixture); 288 at
    RK = 320 and beyond, with or without +I (256 for a mixture)."""
    R = rk // num_states
    room = SMEM_PER_BLOCK - _team_fixed_bytes(num_states, R, mixture)
    rows = _t_stride(num_states, num_states * _slice_rates(num_states, R),
                     has_pinv)
    return room // (rows * 4) // 32 * 32


def t_in_device_memory(consts, width: int, has_pinv: bool = False) -> bool:
    """Whether a launch at sumtable width ``width`` keeps each pair's T in
    the device-memory scratch rather than in shared memory
    (:func:`kernel_geometry`'s ``t_shared``, for the model ``consts``
    holds): past :func:`max_shared_sites`."""
    k = int(consts.A.shape[-1])
    r = int(consts.rates.shape[0])
    return not kernel_geometry(k, r, width, consts.A.ndim == 3 and r > 1,
                               has_pinv)["t_shared"]


def kernel_width(spans) -> int:
    """The kernel's sumtable width for pairs with these spans: the widest
    span rounded up to 32 (each pair reads only its own window)."""
    widest = int(np.max(np.asarray(spans))) if len(spans) else 1
    return max(32, -(-widest // 32) * 32)


def twin_rates(num_states: int, num_rates: int,
               mixture: bool = False) -> bool:
    """More rate categories than the kernel takes (:data:`MAX_RATES`), at
    a count the JAX package never gives its Pallas kernel at any width
    (R K x 32 sites past ``MAX_RK_SITES``) and runs on its XLA twin."""
    return (num_rates > MAX_RATES[(num_states, mixture)]
            and num_states * num_rates * 32 > MAX_RK_SITES)


def twin_route(consts, sliding: bool = True) -> bool:
    """True for the models and modes that the JAX package never gives its
    Pallas kernel (``pallas_blo.blo_supported``) and runs on its XLA twin:
    non-sliding (``--raxml-blo``) BLO, state counts other than 4 and 20
    (binary, genotype), and rate counts past the kernel's cap
    (:func:`twin_rates`: more than 312 at K = 4, 64 at K = 20). The port
    runs the torch twin (ops.newton) there, on the card as well."""
    k = int(consts.A.shape[-1])
    r = int(consts.rates.shape[0])
    return (not sliding or k not in K_STATES
            or twin_rates(k, r, consts.A.ndim == 3 and r > 1))


def blo_unsupported(consts, sliding: bool = True):
    """Why the CUDA kernel cannot take this model, or None: it takes DNA
    (K = 4) and protein (K = 20) with one substitution matrix, and
    protein matrix mixtures (LG4M/LG4X), with 1 to :data:`MAX_RATES` rate
    categories (312 at K = 4, 64 at K = 20, a single matrix or a mixture;
    more take the twin, :func:`twin_route`), with or
    without +I (the engine takes no +I with a mixture), f32 and sliding
    BLO, at any window width."""
    k = int(consts.A.shape[-1])
    r = int(consts.rates.shape[0])
    if not sliding:
        return "non-sliding (--raxml-blo) BLO"
    if k not in K_STATES:
        return f"{k}-state models"
    cap = MAX_RATES[(k, consts.A.ndim == 3 and r > 1)]
    if r > cap:
        return (f"{r} rate categories (the kernel takes 1..{cap} at "
                f"{k} states{' for a mixture' if consts.A.ndim == 3 else ''})")
    if consts.A.dtype != torch.float32:
        return f"{consts.A.dtype} stores (the kernel is f32)"
    return None


def _kernel_scalars(consts, dtype):
    """Scalar tables: exponent lanes x_rk [RK], weighted back-transform
    wA [RK, K] (w_r * A[i,k] rows [r*K+i, k]), plain A [K, K], and piA
    [K, K] (pi_i * A[i,k]) — the factorisation of
    G[k1,k2,k3] = sum_i pi_i A_ik1 A_ik2 A_ik3. A matrix mixture's A and
    piA are per-rate rows [RK, K]."""
    scale = 1.0 / (1.0 - consts.pinv)   # libpll's +I time scaling
    K = consts.A.shape[-1]
    R = consts.rates.shape[0]
    RK = R * K
    if consts.A.ndim == 3:
        x_rk = (consts.eigenvals * consts.rates[:, None] * scale).reshape(RK)
        wA = (consts.weights[:, None, None] * consts.A).reshape(RK, K)
        A = consts.A.reshape(RK, K)
        piA = (consts.freqs[:, :, None] * consts.A).reshape(RK, K)
    else:
        x_rk = (consts.eigenvals[None, :] * consts.rates[:, None]
                * scale).reshape(RK)
        wA = (consts.weights[:, None, None]
              * consts.A[None, :, :]).reshape(RK, K)
        A = consts.A
        piA = consts.freqs[:, None] * consts.A
    return tuple(t.to(dtype).contiguous() for t in (x_rk, wA, A, piA))


def _omp(consts, dtype):
    """1 - pinv as a 1-element tensor on the stores' device (no host sync)."""
    return (1.0 - consts.pinv).to(dtype).reshape(1)


# --------------------------------------------------------------------------
# plain version


def team_site_sum(x, tile: int = 32, warps: int = 1):
    """The kernel's sum over a window's sites, [n, W] -> [n]: thread t of
    the first ``tile`` threads adds sites t, t + tile, ... in turn; each
    warp's 32 thread sums meet in an xor butterfly (lane i adds lane
    i ^ m's value, m = 16 .. 1, which leaves the same float in every lane);
    then the ``warps`` warp sums (zero past the tile) meet in a fixed tree,
    a[i] += a[i + h] for h = warps/2 .. 1. A K = 4 team (``DNA_TEAM``
    threads, one tile) or a K = 20 team (``WIDE_TEAM`` threads, a tile per
    rate)."""
    n, W = x.shape
    x = torch.nn.functional.pad(x, (0, -W % tile)).reshape(n, -1, tile)
    acc = x[:, 0]
    for c in range(1, x.shape[1]):
        acc = acc + x[:, c]
    acc = acc.reshape(n, tile // 32, 32)
    lane = torch.arange(32, device=x.device)
    for m in (16, 8, 4, 2, 1):
        acc = acc + acc[:, :, lane ^ m]
    a = torch.nn.functional.pad(acc[:, :, 0], (0, warps - tile // 32))
    h = warps // 2
    while h:
        a = a[:, :h] + a[:, h:2 * h]
        h //= 2
    return a[:, 0]


def _gather_windows(tU, tV, tQ, e_ids, q_ids, begins, spans, width, skip,
                    invq=None, ls=None):
    """Per-pair windows [P, RK, W] / [P, K, W] starting at each pair's
    begin, zeroed beyond its span (and for dead lanes); plus the mask and,
    with ``invq``/``ls``, the +I term pv = exp(invq[q] - ls[e]) [P, W]
    (zero off the span)."""
    S = tU.shape[2]
    dev = tU.device
    w = torch.arange(width, device=dev)
    idx = begins.long()[:, None] + w[None, :]                  # [P, W]
    valid = (w[None, :] < spans.long()[:, None]) & (idx < S)
    valid = valid & (skip <= 0)[:, None]
    idx = idx.clamp(0, S - 1)
    e = e_ids.long()[:, None, None]
    q = q_ids.long()[:, None, None]
    rk = torch.arange(tU.shape[1], device=dev)[None, :, None]
    kq = torch.arange(tQ.shape[1], device=dev)[None, :, None]
    m = valid.to(tU.dtype)
    tu = tU[e, rk, idx[:, None, :]] * m[:, None, :]
    tv = tV[e, rk, idx[:, None, :]] * m[:, None, :]
    tq = tQ[q, kq, idx[:, None, :]] * m[:, None, :]
    pv = None
    if invq is not None:
        diff = invq[q[:, :, 0], idx] - ls[e[:, :, 0], idx]
        pv = torch.where(valid, torch.exp(diff), torch.zeros_like(diff))
    return tu, tv, tq, m, pv


def blo_newton_plain(tables, tU, tV, tQ, e_ids, q_ids, begins, spans,
                     orig_len, skip, width: int,
                     max_smoothings: int = SMOOTHINGS,
                     counters: bool = False, invq=None, ls=None, omp=None):
    """Plain batched-torch version of the kernel (``_blo_compute``'s
    arithmetic, pairs in lock step with per-pair freezing; a pair's result
    never depends on another's). Same inputs and outputs as
    :data:`blo_newton`, for K = 4 and K = 20, a single matrix or a matrix
    mixture: ``A``/``piA`` of [K, K] or per-rate [RK, K] rows, a query tip
    ``tQ`` of K or RK (per-category) rows. Sums run in the kernel's
    orders (``site_sum``, ``eigen_sums``): back-transform over k,
    contraction over i; at K = 4 f0/f1/f2 and the score over j; at K = 20
    per rate over k, then the rates in order; and the sites as the team
    adds them (thread by thread over tiles, the warp butterfly, the warps
    in a fixed tree). So on a borderline pair both take the same Newton
    stops, and the two agree bit for bit.
    With ``invq`` [Q, S], ``ls`` [E, S] and ``omp``
    (1 - pinv) the +I term joins every site likelihood,
    g = omp * f + exp(invq[q] - ls[e]), in the kernel's order of
    operations. With ``counters``, also returns per-pair executed
    smoothings and inner Newton iterations (the kernel's K5 outputs)."""
    x_rk, wA, A, piA = tables
    dtype = tU.dtype
    tiny = torch.finfo(dtype).tiny
    lam = torch.abs(x_rk).max()          # the fastest eigen rate
    K = A.shape[-1]
    RK = x_rk.shape[0]
    R = RK // K
    zero_lane = [j % K == K - 1 for j in range(RK)]
    tu, tv, tq, mask, pv = _gather_windows(tU, tV, tQ, e_ids, q_ids, begins,
                                           spans, width, skip, invq, ls)
    if pv is not None:
        omp = torch.as_tensor(omp, dtype=dtype, device=tU.device).reshape(())
    P, _, W = tu.shape
    orig = orig_len.to(dtype)
    half = orig * 0.5
    dist_min = torch.clamp(half, max=BRLEN_MIN / 2.0)
    dist_tol = dist_min / 10.0
    dist_max = orig - dist_tol
    # coefficient tables per rate [R, K(i), K(k)]: a matrix mixture's A and
    # piA arrive as per-rate [RK, K] rows, a single matrix's as one [K, K]
    per_rate = lambda t: (t.reshape(R, K, K) if t.shape[0] == RK
                          else t[None].expand(R, K, K))
    wA_r, A_r, piA_r = per_rate(wA), per_rate(A), per_rate(piA)
    n_smooth = torch.zeros(P, dtype=torch.int64, device=tU.device)
    n_iter = torch.zeros(P, dtype=torch.int64, device=tU.device)

    def exps(t):                                             # [n] -> [n, RK]
        return torch.exp(x_rk[None, :] * t[:, None])

    # the kernel's sum over a window's sites: its team's (csrc/blo_newton.cu
    # team_sum), DNA_TEAM threads at K = 4, WIDE_TEAM at K = 20
    tile, warps = ((DNA_TEAM, DNA_TEAM // 32) if K == 4
                   else (32 * max(1, WIDE_TEAM // 32 // R), WIDE_TEAM // 32))

    def site_sum(x):                                         # [n, W] -> [n]
        return team_site_sum(x, tile, warps)

    def eigen_sums(T, E, derivs):
        """Per site, the sums over the RK eigen lanes of T * E (the zero
        lanes add T alone) and, with ``derivs``, of T * E * x and
        T * E * x^2 (the zero lanes add nothing): at K = 4 over j in
        order; at K = 20 per rate over k, then the rates in order."""
        xs = (x_rk, x_rk * x_rk) if derivs else ()
        groups = ([slice(j, j + 1) for j in range(RK)] if K == 4
                  else [slice(k, RK, K) for k in range(K)])
        sums = [None] * (1 + len(xs))
        for g in groups:
            t = T[:, g]
            zero = zero_lane[g.start]
            tE = t if zero else t * E[:, g, None]
            terms = [tE] + ([] if zero else
                            [tE * c[g, None] for c in xs])
            for i, v in enumerate(terms):
                sums[i] = v if sums[i] is None else sums[i] + v
        out = []
        for s in sums:
            acc = s[:, 0]
            for r in range(1, s.shape[1]):
                acc = acc + s[:, r]
            out.append(acc)
        return out

    def tip_rk(t):
        """The query tip over all RK lanes: a mixture's is per category
        already ([n, RK, W]); a single matrix's [n, K, W] serves every
        rate (``tQ_ref[j % Kq]``)."""
        return t if t.shape[1] == RK else t.repeat(1, R, 1)

    def back_transform(X, E, coef):
        """h[r, i] = sum_k coef[r, i, k] * X[r*K+k] * E[r*K+k]."""
        n = X.shape[0]
        zl = torch.tensor(zero_lane, device=X.device)
        E = torch.where(zl[None, :], torch.ones_like(E), E)
        u = (X * E[:, :, None]).reshape(n, R, K, W)
        h = coef[None, :, :, 0, None] * u[:, :, None, 0, :]
        for k in range(1, K):
            h = h + coef[None, :, :, k, None] * u[:, :, None, k, :]
        return h                                             # [n, R, K, W]

    def contract_T(hA, hB, out=None):
        """T[r*K+k] = sum_i piA[r, i, k] hA[r,i] hB[r,i] (* out[r*K+k])."""
        prod = hA * hB
        T = piA_r[None, :, 0, :, None] * prod[:, :, 0:1, :]
        for i in range(1, K):
            T = T + piA_r[None, :, i, :, None] * prod[:, :, i:i + 1, :]
        if out is not None:
            T = T * tip_rk(out).reshape(T.shape)
        return T.reshape(T.shape[0], RK, W)

    def build_T(tu_, tv_, tq_, lp, ld):
        return contract_T(back_transform(tu_, exps(lp), wA_r),
                          back_transform(tv_, exps(ld), A_r), tq_)

    def site_g(f, pv_):
        return f if pv_ is None else omp * f + pv_

    def score_from(T, lq, m, pv_):
        f, = eigen_sums(T, exps(lq), derivs=False)
        g = torch.clamp(site_g(f, pv_), min=tiny)
        return site_sum(m * torch.log(g))

    def newton(T, m, pv_, xmin, xmax, xtol, guess):
        x = torch.minimum(torch.maximum(guess, xmin), xmax)
        span = m.sum(1)
        n = x.shape[0]
        done = torch.zeros(n, dtype=torch.bool, device=x.device)
        iters = torch.zeros(n, dtype=torch.int64, device=x.device)
        slid = torch.zeros_like(x)
        one = torch.ones_like(x)
        x_hi = x
        for _ in range(MAX_ITERS):
            if bool(done.all()):
                break
            f0, f1, f2 = eigen_sums(T, exps(x), derivs=True)
            # +I: g = omp f0 + pv, r1 = (omp f1) / g, f2 -> omp f2
            g = torch.clamp(site_g(f0, pv_), min=tiny)
            inv_g = 1.0 / g
            if pv_ is not None:
                f1 = omp * f1
                f2 = omp * f2
            r1 = f1 * inv_g
            d1 = site_sum(m * r1)
            d2 = site_sum(m * (f2 * inv_g - r1 * r1))
            newton_x = x - d1 / torch.where(d2 == 0, one, d2)
            dirn = torch.where(d1 > 0, one, -one)
            snap = (d2 >= 0) & (slid * dirn > 0)
            bound = torch.where(d1 > 0, xmax, xmin)
            slide = torch.where(snap, bound,
                                torch.where(d1 > 0, (x + xmax) / 2,
                                            (x + xmin) / 2))
            xn = torch.where(d2 < 0, newton_x, slide)
            xn = torch.minimum(torch.maximum(xn, xmin), xmax)
            slid = torch.where(d2 < 0, torch.zeros_like(x), dirn)
            conv = ((torch.abs(xn - x) < xtol)
                    | (torch.abs(d1) <= D1_EPSILON)
                    | ((d2 < 0) & (d1 * d1 <= GAIN_EPSILON * -d2)))
            # the guarded snap (ops.newton.cancelled): a stop on a cancelled
            # evaluation backs off halfway to x_hi, the last point evaluated
            # soundly with d1 < 0, and its crawling step doubles x
            bad = cancelled(d1, x, lam * span)
            # a cancelled evaluation's crawling step: x doubles instead
            crawl = (bad & ~conv & (d1 > 0) & (d2 < 0)
                     & (xn - x < x * 0.125))
            xn = torch.where(crawl, torch.minimum(x + x, xmax), xn)
            slid = torch.where(crawl, torch.zeros_like(x), slid)
            back = conv & bad & (x < x_hi)
            conv = conv & ~back
            xn = torch.where(back, (x_hi + x) * 0.5, xn)
            slid = torch.where(back, torch.zeros_like(x), slid)
            x_hi = torch.where(~done & ~bad & (d1 < 0), x, x_hi)
            iters = iters + (~done).long()
            x = torch.where(done, x, xn)
            done = done | conv
        return x, iters

    pendant = torch.full_like(orig, DEFAULT_PENDANT)
    distal, proximal = half.clone(), half.clone()
    T1 = build_T(tu, tv, tq, half, half)
    neg = -score_from(T1, pendant, mask, pv)
    done = skip > 0
    for _ in range(max_smoothings):
        act = torch.nonzero(~done).flatten()
        if act.numel() == 0:
            break
        sub = lambda x: x.index_select(0, act)
        tu_a, tv_a, tq_a, m_a = sub(tu), sub(tv), sub(tq), sub(mask)
        pv_a = None if pv is None else sub(pv)
        o_a, h_a = sub(orig), sub(half)
        dmin, dtol, dmax = sub(dist_min), sub(dist_tol), sub(dist_max)
        p_a, d_a, pr_a, neg_a = sub(pendant), sub(distal), sub(proximal), \
            sub(neg)
        n_a = act.numel()
        full = lambda v: torch.full((n_a,), v, dtype=dtype, device=o_a.device)

        # --- pendant Newton on T1 (lp, ld fixed)
        guess = torch.where((p_a < BRLEN_MIN) | (p_a > BRLEN_MAX),
                            full(BRLEN_DEFAULT), p_a)
        new_p, it1 = newton(sub(T1), m_a, pv_a, full(BRLEN_MIN),
                            full(BRLEN_MAX), full(BRLEN_MIN / 10.0), guess)
        # --- distal Newton on the role-swapped T2
        T2 = contract_T(back_transform(tu_a, exps(pr_a), wA_r),
                        back_transform(tip_rk(tq_a), exps(new_p),
                                       A_r)) * tv_a
        guess2 = torch.where((d_a < dmin) | (d_a > dmax), h_a, d_a)
        new_d, it2 = newton(T2, m_a, pv_a, dmin, dmax, dtol, guess2)
        new_pr = o_a - new_d
        T_new = build_T(tu_a, tv_a, tq_a, new_pr, new_d)
        new_neg = -score_from(T_new, new_p, m_a, pv_a)

        worse = (new_neg - neg_a) > torch.abs(new_neg) * 1e-14
        converged = torch.abs(new_neg - neg_a) < OPT_BRANCH_EPSILON
        pick = lambda old, new: torch.where(worse, old, new)
        pendant = pendant.index_copy(0, act, pick(p_a, new_p))
        distal = distal.index_copy(0, act, pick(d_a, new_d))
        proximal = proximal.index_copy(0, act, pick(pr_a, new_pr))
        neg = neg.index_copy(0, act, pick(neg_a, new_neg))
        done = done.index_copy(0, act, worse | converged)
        T1 = T1.index_copy(0, act, T_new)
        n_smooth = n_smooth.index_add(0, act, torch.ones_like(act))
        n_iter = n_iter.index_add(0, act, it1 + it2)
    out = (-neg, pendant, distal, proximal, done.to(dtype))
    if counters:
        out += (n_smooth, n_iter)
    return out


def blo_op_count(spans, smoothings, newton_iters, num_rates: int,
                 has_pinv: bool = False, num_states: int = 4) -> float:
    """Floating-point operations the kernel needs for these pairs, counted
    from ``csrc/blo_newton.cu`` (an FMA counts 2; exp, log, max and a
    division count 1 each):

    - sumtable build, per site and rate: 2(K-1) exp-scalings, two K x K
      back-transforms (2 x K x (1 mul + (K-1) FMA)), the piA contraction
      (K products + K x (1 mul + (K-1) FMA)) and K output products
      -> 6K^2 + K - 2 (98 at K = 4, 2418 at K = 20);
    - Newton iteration, per site: per non-zero lane 1 mul + 1 add + 2 FMA
      (6), per zero lane 1 add, then max, div, mul, add, 2 mul, sub (8);
    - score, per site: per non-zero lane an FMA (2), per zero lane 1 add,
      then max, log, add (3);
    - +I: per site the pv row once per pair (sub, exp: 2), per Newton
      iteration omp * f0 + pv, omp * f1, omp * f2 (4), per score
      omp * f + pv (2).

    A matrix mixture's per-rate tables change which coefficients are read,
    not how many operations run. One build and one score start each pair;
    each smoothing adds two builds (T2, then T at the new lengths) and one
    score. ``smoothings`` and ``newton_iters`` are per-pair executed
    counts (the kernel's counters, or :func:`blo_newton_plain`'s)."""
    R, K = num_rates, num_states
    RK = K * R
    build = (6 * K * K + K - 2) * R
    newton_site = 6 * (RK - R) + R + 8 + 4 * has_pinv
    score_site = 2 * (RK - R) + R + 3 + 2 * has_pinv
    spans = np.asarray(spans, np.float64)
    sm = np.asarray(smoothings, np.float64)
    it = np.asarray(newton_iters, np.float64)
    per_pair = spans * ((1 + 2 * sm) * build + (1 + sm) * score_site
                        + it * newton_site + 2 * has_pinv)
    return float(per_pair.sum())


def blo_byte_count(spans, num_rates: int, has_pinv: bool = False,
                   counters: bool = False, num_states: int = 4,
                   mixture: bool = False) -> float:
    """Bytes the kernel must move for these pairs: each pair's windows of
    tU, tV (RK floats per site each) and tQ (K, or RK for a mixture's
    per-category tip), plus invq and ls with +I (8 B per site), read once;
    per pair its ids, window and scalars (24 B) and its five outputs
    (20 B), plus 8 B of counters."""
    RK = num_states * num_rates
    kq = RK if mixture else num_states
    spans = np.asarray(spans, np.float64)
    per_site = (2 * RK + kq) * 4 + 8 * has_pinv
    per_pair = 24 + 20 + 8 * counters
    return float(spans.sum() * per_site + len(spans) * per_pair)


# --------------------------------------------------------------------------
# CUDA kernel


# the kernel's instantiations in parts, one shared library each (the
# source's BLO_PART): K = 4, K = 20 with one matrix, K = 20 mixtures
PARTS = ("dna", "team", "mix")
# the (has_pinv, part) libraries: no +I with a matrix mixture
LIBRARIES = tuple((pinv, part) for pinv in (False, True) for part in PARTS
                  if not (pinv and part == "mix"))


def library_part(num_states: int, mixture: bool) -> str:
    """The part of the kernel's instantiations (:data:`PARTS`) that holds
    a launch at ``num_states`` (a matrix ``mixture`` or not)."""
    return "dna" if num_states == 4 else ("mix" if mixture else "team")


class _BloNewton:
    """The CUDA kernel behind a callable. Launch counts (never plain-version
    calls): ``launches`` all launches, ``pinv_launches`` those with the +I
    term (K2/K4), ``counted_launches`` those with the K5 counters on,
    ``past8_launches`` those at more than 8 rate categories (the K = 4
    runtime-R instantiation, the K = 20 cluster), ``cluster_launches``
    those of the K = 20 cluster (a cluster of CTAs per pair), and
    one count per instantiation family: ``k4_launches`` (DNA),
    ``k20_launches`` (protein, one matrix) and ``mixture_launches``
    (protein matrix mixtures); and one per call shape: ``blocked_launches``
    (pairs reading windows of the full stores, K1/K2) and
    ``per_pair_launches`` (pre-gathered per-pair windows, K3/K4). The
    shared libraries, one per flavour (without and with +I) and part of
    the instantiations (:data:`LIBRARIES`: K = 4, K = 20 with one matrix,
    K = 20 mixtures), are built with nvcc at first use into
    ``epa_ng_tpu_torch/build/``; :meth:`build_all` builds all five at
    once, one nvcc each. ``fmad`` turns on nvcc's mul+add contraction
    (FMA); it is off, so the kernel rounds as its plain version does
    (csrc/blo_newton.cu), and only the FMA timing of ``chip_smoke.py
    --fmad-ab`` turns it on."""

    _COUNTS = ("launches", "pinv_launches", "counted_launches",
               "past8_launches", "cluster_launches", "k4_launches",
               "k20_launches", "mixture_launches", "blocked_launches",
               "per_pair_launches")

    def __init__(self, fmad: bool = False):
        self._counts = dict.fromkeys(self._COUNTS, 0)
        self.build_logs = dict.fromkeys(LIBRARIES, "")
        self.fmad = fmad
        self._libs = {}
        self._locks = {key: threading.Lock() for key in LIBRARIES}
        self._count_lock = threading.Lock()

    @property
    def launches(self) -> int:
        return self._counts["launches"]

    def reset_counts(self):
        with self._count_lock:
            self._counts = dict.fromkeys(self._COUNTS, 0)

    def counts(self) -> dict:
        with self._count_lock:
            return dict(self._counts)

    def build(self, has_pinv: bool = False, part: str = "dna"):
        """Compile csrc/blo_newton.cu for one flavour and part of the
        instantiations (if stale) and load it; idempotent. Raises
        RuntimeError with nvcc's output on failure."""
        key = (has_pinv, part)
        with self._locks[key]:
            lib = self._libs.get(key)
            if lib is not None:
                return lib
            os.makedirs(_BUILD_DIR, exist_ok=True)
            fmad = "true" if self.fmad else "false"
            so = os.path.join(
                _BUILD_DIR,
                f"libblo_newton_pinv{int(has_pinv)}_{part}_fmad_{fmad}.so")
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(_SRC)):
                nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
                tmp = f"{so}.{os.getpid()}.tmp"
                defs = (f"-DBLO_HAS_PINV={int(has_pinv)}",
                        f"-DBLO_PART={PARTS.index(part)}")
                cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                       "-std=c++17", "-O3", f"-fmad={fmad}", "-shared",
                       *defs, "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
                       tmp, _SRC]
                res = subprocess.run(cmd, capture_output=True, text=True)
                self.build_logs[key] = res.stdout + res.stderr
                if res.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed to build csrc/blo_newton.cu "
                        f"({' '.join(defs)}):\n" + self.build_logs[key])
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.blo_newton_launch.restype = i32
            lib.blo_newton_launch.argtypes = (
                [ptr] * 3 + [i32] * 4 + [ptr] * 3 + [ptr] * 6
                + [ptr] * 4 + [i32] * 4 + [ptr] * 2 + [ptr] * 7 + [ptr])
            lib.blo_newton_team_geometry.restype = i32
            lib.blo_newton_team_geometry.argtypes = [i32] * 5 + [ptr]
            lib.blo_newton_error_string.restype = ctypes.c_char_p
            lib.blo_newton_error_string.argtypes = [i32]
            self._libs[key] = lib
            return lib

    def team_geometry(self, num_states: int, R: int, width: int,
                      mixture: bool = False, has_pinv: bool = False,
                      device_t: bool = False) -> dict:
        """The geometry of a launch as the library sets it up on the current
        card: ``threads`` per CTA, ``ctas_per_sm`` (the runtime's
        occupancy), ``shared_bytes``, ``t_shared``, the instantiation's
        ``regs`` per thread, the ``cluster``'s CTAs per pair and the
        ``active_clusters`` the card holds at once (CTAs per SM x SMs for
        a cluster of one), which set the persistent grid; ``device_t`` as
        with a device-memory scratch. All but ``active_clusters``, which
        the card's GPCs set, are :func:`kernel_geometry`'s."""
        lib = self.build(has_pinv, library_part(num_states, mixture))
        geo = (ctypes.c_int * 7)()
        rc = lib.blo_newton_team_geometry(num_states, R, int(mixture), width,
                                          int(device_t), geo)
        if rc != 0:
            msg = lib.blo_newton_error_string(rc).decode()
            raise RuntimeError(f"blo_newton geometry: {msg} ({rc})")
        return dict(threads=geo[0], ctas_per_sm=geo[1],
                    shared_bytes=geo[2], t_shared=bool(geo[3]),
                    regs=geo[4], cluster=geo[5], active_clusters=geo[6])

    def build_all(self):
        """Build every library (:data:`LIBRARIES`) with one nvcc process
        each, side by side."""
        with ThreadPoolExecutor(len(LIBRARIES)) as ex:
            for fut in [ex.submit(self.build, *key) for key in LIBRARIES]:
                fut.result()

    def __call__(self, tables, tU, tV, tQ, e_ids, q_ids, begins, spans,
                 orig_len, skip, width: int,
                 max_smoothings: int = SMOOTHINGS,
                 counters: bool = False, invq=None, ls=None, omp=None,
                 per_pair: bool = False):
        """CPU tensors: the plain version. CUDA tensors: the kernel (or a
        ValueError/RuntimeError; nothing falls back). ``invq`` [Q, S],
        ``ls`` [E, S] and ``omp`` (1 - pinv, a float or a 1-element
        tensor) select the +I kernel; ``counters`` appends the per-pair
        executed smoothings and Newton iterations (int32). ``per_pair``
        says the caller passes pre-gathered windows (row p of the stores
        is pair p's), which the launch counts apart."""
        if tU.device.type != "cuda":
            return blo_newton_plain(tables, tU, tV, tQ, e_ids, q_ids, begins,
                                    spans, orig_len, skip, width,
                                    max_smoothings, counters=counters,
                                    invq=invq, ls=ls, omp=omp)
        x_rk, wA, A, piA = tables
        dev = tU.device
        RK, S = tU.shape[1], tU.shape[2]
        K = int(A.shape[-1])
        R = RK // K
        # a mixture's per-rate A/piA rows; with one rate they are the
        # single-matrix tables
        mixture = A.shape[0] == RK and R > 1
        P = e_ids.shape[0]
        has_pinv = invq is not None
        if tU.dtype != torch.float32 or K not in K_STATES or RK % K:
            raise ValueError("blo_newton takes f32 stores of 4 or 20 states")
        if (tV.shape != tU.shape or tQ.dim() != 3 or tQ.shape[2] != S
                or tQ.shape[1] != (RK if mixture else K)):
            raise ValueError("blo_newton: tU/tV [E,RK,S] and tQ [Q,K,S] "
                             "([Q,RK,S] for a matrix mixture)")
        if (x_rk.shape != (RK,) or wA.shape != (RK, K)
                or A.shape not in ((K, K), (RK, K)) or piA.shape != A.shape):
            raise ValueError("blo_newton: tables x_rk [RK], wA [RK,K] and "
                             "A, piA [K,K] (a mixture's [RK,K])")
        if mixture and (K != 20 or has_pinv):
            raise ValueError("blo_newton: matrix mixtures take 20 states "
                             "and no +I")
        if R > MAX_RATES[(K, mixture)] or width < 1:
            raise ValueError(f"blo_newton: unsupported RK={RK} or "
                             f"width={width}")
        if has_pinv and (ls is None or omp is None
                         or invq.shape != (tQ.shape[0], S)
                         or ls.shape != (tU.shape[0], S)
                         or invq.dtype != torch.float32
                         or ls.dtype != torch.float32):
            raise ValueError("blo_newton: +I takes f32 invq [Q,S], ls [E,S] "
                             "and omp")
        lib = self.build(has_pinv, library_part(K, mixture))
        f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
        i32 = lambda t: t.to(device=dev, dtype=torch.int32).contiguous()
        tU_c, tV_c, tQ_c = tU.contiguous(), tV.contiguous(), tQ.contiguous()
        pinv_args = []
        if has_pinv:
            omp_t = torch.as_tensor(omp, dtype=torch.float32,
                                    device=dev).reshape(1)
            pinv_args = [invq.contiguous(), ls.contiguous(), omp_t]
        args_i = [i32(t) for t in (e_ids, q_ids, begins, spans)]
        args_f = [f32(t) for t in (orig_len, skip, x_rk, wA, A, piA)]
        for t in [tU_c, tV_c, tQ_c] + pinv_args + args_i + args_f:
            if t.device != dev:
                raise ValueError("blo_newton: all tensors on one device")
        outs = [torch.empty(P, dtype=torch.float32, device=dev)
                for _ in range(5)]
        counts = ([torch.empty(P, dtype=torch.int32, device=dev)
                   for _ in range(2)] if counters else [])
        # one persistent CTA (or cluster of CTAs) per resident team; the
        # library keeps T in shared memory where it fits (kernel_geometry
        # mirrors its choice), else in a device-memory scratch of one slice
        # per CTA
        geo = kernel_geometry(K, R, width, mixture, has_pinv)
        C = geo["cluster"]
        blocks, scratch = P * C, None
        if not geo["t_shared"]:
            per_cta = (_t_stride(K, K * geo["slice_rates"], has_pinv)
                       * _t_sites(K, width))
            # the library sets its attributes and reads the occupancy on
            # the current card: make it the one this launch runs on
            with torch.cuda.device(dev):
                held = self.team_geometry(K, R, width, mixture, has_pinv,
                                          device_t=True)["active_clusters"]
            blocks = C * max(1, min(P, held,
                                    T_SCRATCH_BYTES // (per_cta * 4 * C)))
            scratch = torch.empty(blocks * per_cta, dtype=torch.float32,
                                  device=dev)
        # the K = 4 kernel's pair counter, 0 at launch
        next_pair = (torch.zeros(1, dtype=torch.int32, device=dev)
                     if K == 4 else None)
        ptrs = lambda ts: [t.data_ptr() for t in ts]
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = lib.blo_newton_launch(
                tU_c.data_ptr(), tV_c.data_ptr(), tQ_c.data_ptr(), S, K, R,
                int(mixture), *(ptrs(pinv_args) or [None] * 3),
                *ptrs(args_i), *ptrs(args_f), P, width, max_smoothings,
                blocks, None if scratch is None else scratch.data_ptr(),
                None if next_pair is None else next_pair.data_ptr(),
                *ptrs(outs), *(ptrs(counts) or [None] * 2), stream)
        if rc != 0:
            msg = lib.blo_newton_error_string(rc).decode()
            raise RuntimeError(f"blo_newton launch failed: {msg} ({rc})")
        family = ("mixture_launches" if mixture
                  else "k4_launches" if K == 4 else "k20_launches")
        with self._count_lock:
            for key, on in (("launches", True), ("pinv_launches", has_pinv),
                            ("counted_launches", counters),
                            ("past8_launches", R > STATIC_RATES),
                            ("cluster_launches", C > 1),
                            (family, True),
                            ("per_pair_launches", per_pair),
                            ("blocked_launches", not per_pair)):
                self._counts[key] += on
        return tuple(outs + counts)


blo_newton = _BloNewton()


class NewtonWork:
    """Running totals of the Newton work the kernel executed for one
    engine: pairs, smoothings and Newton iterations (both solves, every
    smoothing), summed on the device from the kernel's K5 counters, so
    adding costs no host sync; and the calls of the torch twin
    (``ops.newton.blo_optimize_batch``), which carries no counters. The
    engine's dispatch and finalize threads both launch the Newton, so
    updates take a lock."""

    def __init__(self, device):
        self._totals = torch.zeros(3, dtype=torch.int64, device=device)
        self._twin_launches = 0
        self._lock = threading.Lock()

    def add_twin(self):
        """Count one call of the torch twin."""
        with self._lock:
            self._twin_launches += 1

    def add(self, live, counts):
        """Add one launch's per-pair counters (smoothings, iterations);
        ``live`` marks the pairs it computed (dead lanes count 0 work)."""
        smooth, iters = counts
        step = torch.stack([live.sum(), smooth.sum(), iters.sum()])
        with self._lock:
            # a mesh's shards may launch on other devices than the engine's
            self._totals += step.to(self._totals.device, torch.int64)

    def totals(self) -> dict:
        """The totals so far (one host sync)."""
        with self._lock:
            snap = self._totals.clone()
            twin = self._twin_launches
        pairs, smooth, iters = (int(x) for x in snap.cpu())
        return dict(newton_pairs=pairs, newton_smoothings=smooth,
                    newton_iters=iters, twin_launches=twin)


# --------------------------------------------------------------------------
# wrappers


def blo_optimize_batch_kernel_blocked(consts, tU, tV, tQ, e_ids, q_ids,
                                      begins, spans, orig_len, ls_sum,
                                      block_width: int,
                                      max_smoothings: int = SMOOTHINGS,
                                      skip=None, block_active=None,
                                      invq=None, ls=None,
                                      counters: bool = False):
    """Counterpart of ``blo_optimize_batch_pallas_blocked`` (K1; with +I,
    K2).

    tU, tV: [E, RK, S] and tQ [Q, K, S] ([Q, RK, S] for a matrix
    mixture) full stores; e_ids, q_ids [NP]
    rows of each pair; begins, spans [NP] each pair's site window (absolute
    sites, span <= ``block_width``, the sumtable width: see
    :func:`kernel_width`); orig_len [NP]; ls_sum [NP] per-pair
    masked log-scale sums. NP must be a multiple of PB (the engine's
    control flow pads to it). ``skip`` [NP] (0/1) marks dead lanes whose
    outputs the caller discards; ``block_active`` [NP/PB] zeroes whole
    128-pair groups as the TPU kernel's inactive blocks do.

    +I models pass ``invq`` [Q, S] (the query p-inv log term) and ``ls``
    [E, S] (the store's log-scale): the kernel forms each pair's linear
    invariant term exp(invq[q] - ls[e]) itself, where the TPU path takes a
    materialised ``pinv_lin`` [NP, S]. ``counters`` appends the per-pair
    executed smoothings and Newton iterations (0 for dead lanes; K5).

    Returns (logl, pendant, distal_reported, distal, proximal, done)
    (+ (smoothings, newton_iters) with ``counters``)."""
    NP = e_ids.shape[0]
    if NP % PB:
        raise ValueError(f"pair count {NP} is not a multiple of {PB}")
    dtype = tU.dtype
    if skip is None:
        skip = torch.zeros(NP, dtype=dtype, device=tU.device)
    skip = skip.to(dtype)
    active = None
    if block_active is not None:
        active = block_active.repeat_interleave(PB) > 0
        skip = torch.where(active, skip, torch.ones_like(skip))
    tables = _kernel_scalars(consts, dtype)
    omp = None if invq is None else _omp(consts, dtype)
    out = blo_newton(
        tables, tU, tV, tQ, e_ids, q_ids, begins, spans, orig_len, skip,
        block_width, max_smoothings, counters=counters, invq=invq, ls=ls,
        omp=omp)
    logl, pendant, distal, proximal, done = out[:5]
    if active is not None:
        zero = lambda x: torch.where(active, x, torch.zeros_like(x))
        logl, pendant, distal, proximal, done = map(
            zero, (logl, pendant, distal, proximal, done))
    logl = logl + ls_sum
    done_b = done > 0
    distal_rep = (orig_len / (distal + proximal)) * distal
    return (logl, pendant, distal_rep, distal, proximal, done_b) + out[5:]


def blo_optimize_batch_kernel(consts, tU, tV, tQ, ls, site_mask, orig_len,
                              inv_logfreq=None,
                              max_smoothings: int = SMOOTHINGS,
                              has_pinv: bool = False,
                              counters: bool = False):
    """Counterpart of ``blo_optimize_batch_pallas`` (sliding mode; K3, with
    +I K4): tU, tV [B, RK, W] pre-sliced windows; tQ [B, K, W] ([B, RK,
    W] for a matrix mixture); ls,
    site_mask [B, W]; orig_len [B]. Every caller's site mask is one
    contiguous run per pair, which becomes that pair's (begin, span)
    window. With ``has_pinv`` (+I models) ``inv_logfreq`` [B, W] and ``ls``
    feed the kernel's invariant term exp(inv_logfreq - ls), row b for pair
    b; otherwise ``inv_logfreq`` is accepted for signature parity and
    ignored. ``counters`` appends the per-pair executed smoothings and
    Newton iterations (K5; the TPU kernel counts per 128-pair block).

    Returns (logl, pendant, distal_reported, distal, proximal, done)
    (+ (smoothings, newton_iters) with ``counters``)."""
    B, RK, W = tU.shape
    dev = tU.device
    on = site_mask > 0
    spans = on.sum(dim=1).to(torch.int32)
    begins = torch.argmax(on.to(torch.int32), dim=1).to(torch.int32)
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    skip = torch.zeros(B, dtype=tU.dtype, device=dev)
    tables = _kernel_scalars(consts, tU.dtype)
    pinv = {}
    if has_pinv:
        pinv = dict(invq=inv_logfreq.to(tU.dtype), ls=ls,
                    omp=_omp(consts, tU.dtype))
    out = blo_newton(
        tables, tU, tV, tQ, ids, ids, begins, spans, orig_len, skip, W,
        max_smoothings, counters=counters, per_pair=True, **pinv)
    logl, pendant, distal, proximal, done = out[:5]
    logl = logl + torch.sum(site_mask * ls, dim=1)
    distal_rep = (orig_len / (distal + proximal)) * distal
    return (logl, pendant, distal_rep, distal, proximal, done > 0) + out[5:]

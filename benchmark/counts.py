"""The yardstick of the Newton kernel's roofline: a frozen copy of the
port's operation and byte counts (``ops/blo_kernel.py::blo_op_count`` and
``blo_byte_count``, counted from ``csrc/blo_newton.cu``) and the published
peaks of one NVIDIA H100 SXM (the data sheet's dense float32 rate outside
the tensor cores and its HBM3 bandwidth, at the full 700 W).

Operations (an FMA counts 2; exp, log, max and a division 1 each):

- sumtable build, per site and rate: 2(K-1) exp-scalings, two K x K
  back-transforms, the piA contraction and K output products
  -> 6K^2 + K - 2;
- Newton iteration, per site: 6 per non-zero lane, 1 per zero lane, then
  8; score, per site: 2 per non-zero lane, 1 per zero lane, then 3;
- +I: per site 2 once a pair, 4 a Newton iteration, 2 a score.

One build and one score start each pair; each smoothing adds two builds
and one score. Bytes (``blo_byte_count``, the port's): each pair's windows
of tU, tV (RK floats a site each) and tQ (K, or RK for a mixture), 8 B a
site more with +I, read once; per pair 24 B in, 20 B out and 8 B of
counters. A launch's bound (``launch_bound``) counts each input byte once
however many of its pairs read it: the distinct (edge, site) cells of tU
and tV (and of ls with +I), the distinct (read, site) cells of tQ (and of
invq), and the per-pair bytes.
"""

from __future__ import annotations

import numpy as np

PEAK_F32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12    # H100 SXM, HBM3


def coefficients(num_states: int, num_rates: int, has_pinv: bool = False,
                 counters: bool = True, mixture: bool = False) -> dict:
    """Per-site and per-pair terms of the two counts."""
    R, K = num_rates, num_states
    RK = K * R
    kq = RK if mixture else K
    return dict(
        build=(6 * K * K + K - 2) * R,
        newton_site=6 * (RK - R) + R + 8 + 4 * has_pinv,
        score_site=2 * (RK - R) + R + 3 + 2 * has_pinv,
        pinv_site=2 * has_pinv,
        site_bytes=(2 * RK + kq) * 4 + 8 * has_pinv,
        edge_site_bytes=2 * RK * 4 + 4 * has_pinv,
        query_site_bytes=kq * 4 + 4 * has_pinv,
        pair_bytes=24 + 20 + 8 * counters)


def blo_op_count(spans, smoothings, newton_iters, num_rates: int,
                 has_pinv: bool = False, num_states: int = 4) -> float:
    c = coefficients(num_states, num_rates, has_pinv)
    spans = np.asarray(spans, np.float64)
    sm = np.asarray(smoothings, np.float64)
    it = np.asarray(newton_iters, np.float64)
    per_pair = spans * ((1 + 2 * sm) * c["build"]
                        + (1 + sm) * c["score_site"]
                        + it * c["newton_site"] + c["pinv_site"])
    return float(per_pair.sum())


def blo_byte_count(spans, num_rates: int, has_pinv: bool = False,
                   counters: bool = False, num_states: int = 4,
                   mixture: bool = False) -> float:
    c = coefficients(num_states, num_rates, has_pinv, counters, mixture)
    spans = np.asarray(spans, np.float64)
    return float(spans.sum() * c["site_bytes"] + len(spans) * c["pair_bytes"])


def launch_bound(sums, coef: dict) -> tuple:
    """(operations, bytes, bound seconds) of one launch from its sums over
    live pairs: (span, span x smoothings, span x iterations, pairs,
    distinct edge-store cells, distinct query-store cells)."""
    s1, s_sm, s_it, n, cells_e, cells_q = (float(x) for x in sums)
    ops = (coef["build"] * (s1 + 2 * s_sm) + coef["score_site"] * (s1 + s_sm)
           + coef["newton_site"] * s_it + coef["pinv_site"] * s1)
    nbytes = (coef["edge_site_bytes"] * cells_e
              + coef["query_site_bytes"] * cells_q + coef["pair_bytes"] * n)
    return ops, nbytes, max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)

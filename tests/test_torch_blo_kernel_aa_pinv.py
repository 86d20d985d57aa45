"""The +I call shape (K4) of the CUDA Newton kernel's plain version at
K = 20 against the JAX package's +I Pallas kernel in interpret mode
(LG+I{0.2}+G2, f32 on the CPU; see test_torch_blo_kernel_aa.py for the
rule)."""

import numpy as np
import torch

from epa_ng_tpu.ops import pallas_blo as jpb

from epa_ng_tpu_torch.ops import blo_kernel as bk
from test_torch_blo_kernel_aa import (T, _compare, _pairs, _per_pair_args,
                                      _state)

# one intra-op thread per test process: the suite runs in parallel
# workers, and a thread per core in each of them oversubscribes the
# CPU and slows the small tensor ops here by orders of magnitude
torch.set_num_threads(1)


def test_plain_matches_pallas_pinv_lg_interpret():
    """K4 at K = 20: LG+I{0.2}+G2 on data with 20% invariant columns."""
    st = _state("LG+I{0.2}+G2{0.8}", 12, 64, 8, seed=9, invariant=0.2)
    pe, pq, pb, sp = _pairs(st, 24, seed=5)
    lin = np.exp(np.asarray(st["invq"])[pq] - np.asarray(st["blo"].ls)[pe])
    site = np.arange(st["S"])
    span = (site[None] >= pb[:, None]) & (site[None] < (pb + sp)[:, None])
    assert (lin[span] > 0).mean() > 0.05
    args = _per_pair_args(st, pe, pq, pb, sp, True)
    ref = jpb.blo_optimize_batch_pallas(st["eng"].consts, *args,
                                        interpret=True, has_pinv=True)
    got = bk.blo_optimize_batch_kernel(st["tconsts"], *[T(a) for a in args],
                                       has_pinv=True)
    _compare(ref, got)

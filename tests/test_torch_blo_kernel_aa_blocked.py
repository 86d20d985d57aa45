"""The blocked call shape (K1) of the CUDA Newton kernel's plain version at
K = 20 against the JAX package's blocked Pallas kernel in interpret mode
(LG+G2, f32 on the CPU; see test_torch_blo_kernel_aa.py for the rule)."""

import numpy as np
import torch
import jax.numpy as jnp
import pytest

from epa_ng_tpu.ops import pallas_blo as jpb

from epa_ng_tpu_torch.ops import blo_kernel as bk
from test_torch_blo_kernel_aa import (T, _compare, _pairs, _per_pair_args,
                                      _state)

# one intra-op thread per test process: the suite runs in parallel
# workers, and a thread per core in each of them oversubscribes the
# CPU and slows the small tensor ops here by orders of magnitude
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lg_state():
    return _state("LG+G2{0.8}", 12, 64, 8, seed=7)


def test_plain_matches_pallas_blocked_lg_interpret(lg_state):
    """K1 at K = 20: the JAX kernel gets row-gathered tensors and a mask
    relative to its 128-pair block's window; the port reads the full
    stores by id. 24 pairs, padded to one block by repeating the last."""
    st = lg_state
    pe, pq, pb, sp = (np.concatenate([x, np.repeat(x[-1:], jpb.PB - 24)])
                      for x in _pairs(st, 24, seed=3))
    S = st["S"]
    offs, Wb = jpb.plan_blocks_pairs(pb, pb + sp, S)
    Wk = bk.kernel_width(sp)
    local = pb - np.repeat(offs, jpb.PB)
    w = np.arange(Wb)
    bmask = ((w[None] >= local[:, None])
             & (w[None] < (local + sp)[:, None])).astype(np.float32)
    site = np.arange(S)
    full = ((site[None] >= pb[:, None])
            & (site[None] < (pb + sp)[:, None])).astype(np.float32)
    blo, tQ = st["blo"], st["tQ"]
    ls_sum = (full * np.asarray(blo.ls)[pe]).sum(1).astype(np.float32)
    ref = jpb.blo_optimize_batch_pallas_blocked(
        st["eng"].consts, blo.tU[pe], blo.tV[pe], tQ[pq],
        jnp.asarray(bmask), blo.lengths[pe], jnp.asarray(offs),
        jnp.asarray(ls_sum), block_width=Wb, interpret=True)
    tb = st["tblo"]
    got = bk.blo_optimize_batch_kernel_blocked(
        st["tconsts"], tb.tU, tb.tV, T(tQ), T(pe), T(pq), T(pb), T(sp),
        tb.lengths[T(pe).long()], T(ls_sum), Wk)
    _compare(ref, got)

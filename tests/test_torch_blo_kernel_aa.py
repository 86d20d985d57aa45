"""The CUDA Newton kernel's plain version (ops.blo_kernel) at K = 20 against
the JAX package's Pallas kernels in interpret mode, on the same pairs and
the same ``_kernel_scalars``, f32 on the CPU: protein (LG) through the
per-pair call shape (K3), and a synthetic two-component matrix mixture
(per-rate coefficient tables, a per-category query tip) through K3. The
blocked shape (K1) and LG+I (K4) are in test_torch_blo_kernel_aa_blocked.py
and test_torch_blo_kernel_aa_pinv.py: each interpret-mode case takes minutes
on the CPU, and the tier-1 run keeps a file on one worker.

Two rate categories, as tests/test_pallas.py's K = 20 tests: the
interpreter compiles the unrolled R*K^2 back-transform on the CPU, which
takes minutes at R = 4. Four categories are held against the JAX XLA twin
(``epa_ng_tpu.ops.newton.blo_optimize_batch``) instead. Tolerances are
tests/test_pallas.py's: logl within 0.05 absolute, branch lengths by the
0.9 quantile (< 0.01) over logl-sharp pairs plus a loose max.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from epa_ng_tpu.core.engine import PlacementEngine
from epa_ng_tpu.models import Model, aa_matrices
from epa_ng_tpu.ops import newton as jnewton
from epa_ng_tpu.ops import pallas_blo as jpb
from epa_ng_tpu.utils.options import Options
from epa_ng_tpu.utils.synth import AA, synth_dataset

from epa_ng_tpu_torch.core.engine import state_from_numpy
from epa_ng_tpu_torch.ops import blo_kernel as bk

# one intra-op thread per test process: the suite runs in parallel
# workers, and a thread per core in each of them oversubscribes the
# CPU and slows the small tensor ops here by orders of magnitude
torch.set_num_threads(1)


def T(x):
    return torch.as_tensor(np.array(x))


def mixture_components(n: int, seed: int = 11):
    """``n`` components derived from LG as the JAX bench derives them
    (rates and frequencies times exp(0.35 randn), ``RandomState(seed)``)."""
    rng = np.random.RandomState(seed)
    lg_rates, lg_freqs = aa_matrices.MATRICES["LG"]
    comps = []
    for _ in range(n):
        r = lg_rates * np.exp(0.35 * rng.randn(190))
        f = lg_freqs * np.exp(0.35 * rng.randn(20))
        comps.append((r, f / f.sum()))
    return comps


def _state(model, n_taxa, sites, n_queries, seed, invariant=0.0):
    """A JAX f32 engine on random AA data, its query tensors and the same
    state as port tensors. With ``invariant``, that share of the columns
    is made invariant (chip_smoke.with_invariant_sites), so the +I term
    bites."""
    tree, ref, qry = synth_dataset(n_taxa=n_taxa, sites=sites,
                                   n_queries=n_queries, seed=seed,
                                   alphabet=AA)
    if invariant:
        from chip_smoke import with_invariant_sites
        freqs = aa_matrices.MATRICES["LG"][1]
        ref, qry, _ = with_invariant_sites(ref, qry, freqs, invariant,
                                           seed=seed, alphabet=AA)
    eng = PlacementEngine(tree, ref, Model.from_string(model),
                          Options(compute_dtype="f32"))
    codes, qmasks, ranges = eng._encode_chunk(qry)
    tQ, invq = eng._query_tensors(qmasks)
    tconsts, tblo, _ = state_from_numpy(eng.consts, eng.blo,
                                        eng.lookup_table, device="cpu")
    return dict(eng=eng, blo=eng.blo, tblo=tblo, tQ=tQ, invq=invq,
                ranges=ranges, tconsts=tconsts, S=sites, Q=n_queries)


@pytest.fixture(scope="module")
def mixture_registered():
    aa_matrices.MIXTURES["TESTBLOMIX"] = (mixture_components(2), "gamma")
    yield "TESTBLOMIX"
    aa_matrices.MIXTURES.pop("TESTBLOMIX", None)


def _pairs(st, P, seed):
    rng = np.random.default_rng(seed)
    pe = rng.integers(0, st["eng"].num_edges, P).astype(np.int32)
    pq = rng.integers(0, st["Q"], P).astype(np.int32)
    order = np.argsort(st["ranges"][pq, 0], kind="stable")
    pe, pq = pe[order], pq[order]
    return (pe, pq, st["ranges"][pq, 0].astype(np.int32),
            st["ranges"][pq, 1].astype(np.int32))


def _per_pair_args(st, pe, pq, pb, sp, with_inv):
    """Pre-sliced windows as wide as the alignment (the engine's bucketed
    path cuts them so)."""
    S = st["S"]
    site = np.arange(S)
    sm = ((site[None] >= pb[:, None])
          & (site[None] < (pb + sp)[:, None])).astype(np.float32)
    blo = st["blo"]
    inv = (np.asarray(st["invq"])[pq] if with_inv
           else np.full(sm.shape, -np.inf, np.float32))
    args = (np.asarray(blo.tU)[pe], np.asarray(blo.tV)[pe],
            np.asarray(st["tQ"])[pq], np.asarray(blo.ls)[pe], sm,
            np.asarray(blo.lengths)[pe], inv)
    return tuple(jnp.asarray(a) for a in args)


def _compare(ref, got, median_rel=1e-6):
    ref = [np.asarray(x) for x in ref]
    got = [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
           for x in got]
    logl_diff = np.abs(ref[0] - got[0])
    assert logl_diff.max() < 0.05, logl_diff.max()
    sharp = logl_diff < 1e-3
    assert sharp.mean() > 0.9
    for i in (1, 2):
        d = np.abs(ref[i] - got[i])[sharp]
        assert np.quantile(d, 0.9) < 0.01
        assert d.max() < 10.0
    # the same arithmetic: tight where both agree the pair is sharp
    if median_rel is not None:
        assert np.median(logl_diff / np.abs(ref[0])) < median_rel


@pytest.fixture(scope="module")
def lg_state():
    return _state("LG+G2{0.8}", 12, 64, 8, seed=7)


def test_plain_matches_pallas_per_pair_lg_interpret(lg_state):
    """K3 at K = 20: 24 pairs on pre-sliced windows."""
    st = lg_state
    pe, pq, pb, sp = _pairs(st, 24, seed=2)
    args = _per_pair_args(st, pe, pq, pb, sp, False)
    assert st["tQ"].shape[1] == 20 and st["blo"].tU.shape[1] == 40
    ref = jpb.blo_optimize_batch_pallas(st["eng"].consts, *args,
                                        interpret=True)
    got = bk.blo_optimize_batch_kernel(st["tconsts"], *[T(a) for a in args])
    _compare(ref, got)


def test_plain_matches_pallas_mixture_interpret(mixture_registered):
    """K3 for a matrix mixture: A and piA arrive as per-rate [RK, K] rows
    and the query tip has RK per-category rows; the plain version must
    read rate r's rows for rate r (16 pairs, 10 taxa x 48 sites)."""
    st = _state(f"{mixture_registered}+G2{{0.9}}", 10, 48, 6, seed=15)
    tables = bk._kernel_scalars(st["tconsts"], torch.float32)
    assert tables[2].shape == (40, 20) and tables[3].shape == (40, 20)
    assert st["tQ"].shape[1] == 40
    pe, pq, pb, sp = _pairs(st, 16, seed=4)
    args = _per_pair_args(st, pe, pq, pb, sp, False)
    ref = jpb.blo_optimize_batch_pallas(st["eng"].consts, *args,
                                        interpret=True)
    got = bk.blo_optimize_batch_kernel(st["tconsts"], *[T(a) for a in args])
    _compare(ref, got)
    # the per-rate rows matter: rate 0's tables for every rate differ
    one = st["tconsts"]._replace(
        A=st["tconsts"].A[:1].expand(2, 20, 20),
        freqs=st["tconsts"].freqs[:1].expand(2, 20))
    off = bk.blo_optimize_batch_kernel(one, *[T(a) for a in args])
    assert (off[0] - got[0]).abs().max() > 0.05


@pytest.mark.parametrize("model", ["LG+G4{0.8}", "mixture"])
def test_plain_matches_xla_twin_four_rates(model, mixture_registered):
    """R = 4 (RK = 80, the main paths' width) against the JAX XLA twin:
    another form of the same optimum (a sumtable of the normal-basis
    partials), so logl agrees by the interpret-mode rule, not bit for
    bit."""
    name = (f"{mixture_registered}4+G4{{0.9}}" if model == "mixture"
            else model)
    if model == "mixture":
        aa_matrices.MIXTURES[f"{mixture_registered}4"] = (
            mixture_components(4), "gamma")
    try:
        st = _state(name, 12, 64, 8, seed=13)
        assert st["blo"].tU.shape[1] == 80
        pe, pq, pb, sp = _pairs(st, 32, seed=6)
        args = _per_pair_args(st, pe, pq, pb, sp, False)
        ref = jnewton.blo_optimize_batch(st["eng"].consts, *args,
                                         sliding=True)
        got = bk.blo_optimize_batch_kernel(st["tconsts"],
                                           *[T(a) for a in args])
        _compare(ref, got, median_rel=1e-5)
    finally:
        aa_matrices.MIXTURES.pop(f"{mixture_registered}4", None)

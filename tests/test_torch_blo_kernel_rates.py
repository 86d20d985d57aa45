"""The CUDA Newton kernel's plain version (ops.blo_kernel) past 8 rate
categories, against the JAX package on the same pairs, f32 on the CPU.

K = 4 and K = 4 +I at R = 9 and R = 16 run against the Pallas kernel in
interpret mode (K3/K4, one 128-pair block at a width of 64), under
tests/test_pallas.py's tolerances: logl within 0.05 absolute, branch
lengths by the 0.9 quantile (< 0.01) over logl-sharp pairs plus a loose
max, and a median relative logl difference under 1e-6 (no pair of these
blocks meets the f32 Newton stall; tests/test_torch_stall.py holds
pairs that do).

K = 20 at R = 9 and R = 16 runs against the JAX XLA twin
(``epa_ng_tpu.ops.newton.blo_optimize_batch``), the reference that the JAX
package's own K = 20 tests hold its Pallas kernel to: the interpreter
compiles the unrolled R * K^2 back-transforms on the CPU, which takes
minutes at R = 2 and many more at R = 4, on a single 128-pair block.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from epa_ng_tpu.core.engine import PlacementEngine
from epa_ng_tpu.models import Model
from epa_ng_tpu.ops import newton as jnewton
from epa_ng_tpu.ops import pallas_blo as jpb
from epa_ng_tpu.utils.options import Options
from epa_ng_tpu.utils.synth import synth_dataset

from epa_ng_tpu_torch.core.engine import state_from_numpy
from epa_ng_tpu_torch.ops import blo_kernel as bk
from test_torch_blo_kernel_aa import _compare

# one intra-op thread per test process: the suite runs in parallel
# workers, and a thread per core in each of them oversubscribes the
# CPU and slows the small tensor ops here by orders of magnitude
torch.set_num_threads(1)

S = 64
P = 128


def T(x):
    return torch.as_tensor(np.array(x))


def gtr(R, pinv=False):
    return ("GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}"
            f"+G{R}{{0.6}}" + ("+I{0.25}" if pinv else ""))


def dna_state(model, invariant=0.0, seed=21):
    """A JAX f32 engine on random DNA data (16 taxa, S sites; with
    ``invariant``, that share of the columns made invariant, so the +I term
    bites), its query tensors and the same state as port tensors."""
    tree, ref, qry = synth_dataset(n_taxa=16, sites=S, n_queries=16,
                                   seed=seed)
    if invariant:
        from chip_smoke import with_invariant_sites
        ref, qry, _ = with_invariant_sites(
            ref, qry, (0.27, 0.23, 0.24, 0.26), invariant, seed=seed)
    eng = PlacementEngine(tree, ref, Model.from_string(model),
                          Options(compute_dtype="f32"))
    codes, qmasks, ranges = eng._encode_chunk(qry)
    tQ, invq = eng._query_tensors(qmasks)
    tconsts, tblo, _ = state_from_numpy(eng.consts, eng.blo,
                                        eng.lookup_table, device="cpu")
    return dict(eng=eng, blo=eng.blo, tblo=tblo, tQ=tQ, invq=invq,
                ranges=ranges, tconsts=tconsts)


def per_pair_args(st, n_pairs, seed, with_inv):
    """Random (query, edge) pairs and their pre-sliced windows, as wide as
    the alignment."""
    rng = np.random.default_rng(seed)
    pe = rng.integers(0, st["eng"].num_edges, n_pairs).astype(np.int32)
    pq = rng.integers(0, st["tQ"].shape[0], n_pairs).astype(np.int32)
    pb = st["ranges"][pq, 0].astype(np.int32)
    sp = st["ranges"][pq, 1].astype(np.int32)
    site = np.arange(st["blo"].tU.shape[2])
    sm = ((site[None] >= pb[:, None])
          & (site[None] < (pb + sp)[:, None])).astype(np.float32)
    blo = st["blo"]
    inv = (np.asarray(st["invq"])[pq] if with_inv
           else np.full(sm.shape, -np.inf, np.float32))
    return (np.asarray(blo.tU)[pe], np.asarray(blo.tV)[pe],
            np.asarray(st["tQ"])[pq], np.asarray(blo.ls)[pe], sm,
            np.asarray(blo.lengths)[pe], inv)


@pytest.mark.parametrize("R", [9, 16])
@pytest.mark.parametrize("pinv", [False, True])
def test_plain_matches_pallas_interpret_past_eight_rates(R, pinv):
    """K3 (K4 with +I) at R = 9 (the runtime-R instantiation's smallest
    rate count) and R = 16: 128 pairs on pre-sliced 64-site windows, the
    +I model on data with 20% invariant columns."""
    st = dna_state(gtr(R, pinv), invariant=0.2 if pinv else 0.0)
    assert st["blo"].tU.shape[1] == 4 * R
    args = per_pair_args(st, P, seed=R, with_inv=pinv)
    if pinv:
        lin = np.exp(args[6] - args[3])
        assert (lin[args[4] > 0] > 0).mean() > 0.05
    ref = jpb.blo_optimize_batch_pallas(
        st["eng"].consts, *[jnp.asarray(a) for a in args], interpret=True,
        has_pinv=pinv)
    got = bk.blo_optimize_batch_kernel(st["tconsts"], *[T(a) for a in args],
                                       has_pinv=pinv)
    _compare(ref, got)


@pytest.mark.parametrize("R", [9, 16])
def test_plain_matches_xla_twin_past_eight_rates_k20(R):
    """K = 20 at R = 9 and R = 16 (a cluster of two CTAs a pair on the card)
    against the JAX XLA twin on LG-evolved reads (the protein main path's
    kind of data; on random protein reads most pairs are flat in their
    lengths): another form of the same optimum (a sumtable of the
    normal-basis partials), so logl agrees by the interpret-mode rule, not
    bit for bit."""
    from epa_ng_tpu.utils.synth import AA, evolved_dataset
    model = f"LG+G{R}{{0.8}}"
    tree, ref, qry, _ = evolved_dataset(n_taxa=12, sites=S, n_queries=8,
                                        seed=13, model_str=model,
                                        alphabet=AA)
    eng = PlacementEngine(tree, ref, Model.from_string(model),
                          Options(compute_dtype="f32"))
    codes, qmasks, ranges = eng._encode_chunk(qry)
    tQ, invq = eng._query_tensors(qmasks)
    tconsts, _, _ = state_from_numpy(eng.consts, eng.blo, eng.lookup_table,
                                     device="cpu")
    st = dict(eng=eng, blo=eng.blo, tQ=tQ, invq=invq, ranges=ranges)
    assert eng.blo.tU.shape[1] == 20 * R
    args = per_pair_args(st, 32, seed=R, with_inv=False)
    ref = jnewton.blo_optimize_batch(eng.consts,
                                     *[jnp.asarray(a) for a in args],
                                     sliding=True)
    got = bk.blo_optimize_batch_kernel(tconsts, *[T(a) for a in args])
    _compare(ref, got, median_rel=1e-5)


R10 = ("GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+I{0.2}"
       "+R10{0.05/0.15/0.3/0.5/0.7/0.9/1.2/1.6/2.2/3.4}")


@pytest.mark.parametrize("model", [gtr(16), R10])
def test_f32_twin_matches_f64_past_eight_rates(model):
    """The port's torch twin in f32 against itself in f64 on a small
    reference (24 taxa x 160 sites, 32 evolved reads; +R10 with 20% of the
    columns invariant, so its +I term bites): every read's best logl
    within 1e-5 relative, and its top edge the f64 run's up to ties (an
    edge the f64 run scores within 1e-5 relative of its best)."""
    from chip_smoke import FREQS, with_invariant_sites
    from epa_ng_tpu_torch.core.engine import PlacementEngine as TEngine
    from epa_ng_tpu_torch.models import Model as TModel
    from epa_ng_tpu_torch.utils.options import Options as TOptions
    from epa_ng_tpu_torch.utils.synth import evolved_dataset
    tree, ref, qry, _ = evolved_dataset(n_taxa=24, sites=160, n_queries=32,
                                        seed=7)
    if "+I" in model:
        ref, qry, _ = with_invariant_sites(ref, qry, FREQS, 0.2, seed=7)
    runs = {}
    for dt in ("f32", "f64"):
        eng = TEngine(tree, ref, TModel.from_string(model),
                      TOptions(compute_dtype=dt), device="cpu")
        assert eng.consts.rates.shape[0] == (16 if "G16" in model else 10)
        runs[dt] = eng.place_chunk(qry)
    agree = []
    for x, y in zip(runs["f64"], runs["f32"]):
        assert y.logls[0] == pytest.approx(x.logls[0], rel=1e-5)
        ll = dict(zip(x.edge_nums.tolist(), x.logls.tolist()))
        agree.append(ll.get(int(y.edge_nums[0]), -np.inf)
                     >= x.logls[0] - 1e-5 * abs(x.logls[0]))
    assert np.mean(agree) >= 0.99

"""Port parity, fused step: ``parallel.mesh.placement_step`` against the JAX
package's ``placement_step(use_pallas=False)`` on the same chunk, f64 on
the CPU, both through the port's twin branch and through its kernel
branch (the plain version of the CUDA kernel on CPU tensors).

Top edges come from the preplacement GEMM and the stable top-k, so they
must be identical (ties resolve in edge order in both packages). The twin
agrees to 1e-8 absolute in logl and 1e-7 in lengths; the kernel branch
computes the same optimum in the trilinear eigenbasis form and agrees to
1e-6 relative in logl, with lengths compared by the 0.9 quantile over
sharp pairs (tests/test_pallas.py's rule for logl-flat pairs).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from epa_ng_tpu.core.engine import PlacementEngine
from epa_ng_tpu.models import Model
from epa_ng_tpu.parallel import mesh as jmesh
from epa_ng_tpu.utils.options import Options
from epa_ng_tpu.utils.synth import evolved_dataset

from epa_ng_tpu_torch.core.engine import state_from_numpy
from epa_ng_tpu_torch.ops import blo_kernel as bk
from epa_ng_tpu_torch.parallel import mesh as tmesh

# one intra-op thread per test process: the suite runs in parallel
# workers, and a thread per core in each of them oversubscribes the
# CPU and slows the small tensor ops here by orders of magnitude
torch.set_num_threads(1)

TOPK = 8


def T(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def chunk():
    tree, ref, qry, _ = evolved_dataset(n_taxa=32, sites=160, n_queries=64,
                                        seed=2)
    eng = PlacementEngine(tree, ref, Model.from_string(
        "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G4{0.6}"),
        Options())
    ec = eng.encode_msa(qry)
    perm = np.argsort(ec.ranges[:, 0], kind="stable")
    codes, ranges = ec.codes[perm], ec.ranges[perm]
    tQ, invq = eng._query_tensors_codes(codes)
    blo = eng.blo
    jargs = (eng.consts, eng.lookup_table, blo.tU, blo.tV, blo.ls,
             blo.lengths, jnp.asarray(codes), jnp.asarray(ranges[:, 0]),
             jnp.asarray(ranges[:, 1]), tQ, invq,
             jnp.asarray(0.99999, jnp.float64))
    consts, blo_t, table = state_from_numpy(eng.consts, blo,
                                            eng.lookup_table, device="cpu")
    targs = (consts, table, *blo_t, *(T(a) for a in jargs[6:11]), 0.99999)
    W = jmesh.chunk_site_width(ranges[:, 1], 160)
    ref_out = jmesh.placement_step(*jargs, topk=TOPK, site_width=W,
                                   use_pallas=False)
    return dict(targs=targs, jargs=jargs, W=W, ranges=ranges,
                ref=[np.asarray(x) for x in ref_out])


def test_select_topk_ties_in_index_order():
    scores = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    top_edges, valid, top_scores = tmesh._select_topk(scores, 0.99999, 4)
    assert top_edges.tolist() == [[1, 2, 4, 3]]
    import jax
    _, jidx = jax.lax.top_k(jnp.asarray(scores.numpy()), 4)
    assert np.asarray(jidx).tolist() == top_edges.tolist()


def test_fused_step_twin_matches_jax(chunk):
    out = [x.numpy() for x in tmesh.placement_step(
        *chunk["targs"], topk=TOPK, site_width=chunk["W"])]
    ref = chunk["ref"]
    np.testing.assert_array_equal(out[0], ref[0])       # top edges
    np.testing.assert_array_equal(out[5], ref[5])       # valid
    np.testing.assert_array_equal(out[6], ref[6])       # computed
    ok = ref[5] & (ref[6] > 0)
    np.testing.assert_allclose(out[1][ok], ref[1][ok], atol=1e-8, rtol=0)
    np.testing.assert_allclose(out[2][ok], ref[2][ok], atol=1e-8, rtol=0)
    for i in (3, 4):                                     # pendant, distal
        np.testing.assert_allclose(out[i][ok], ref[i][ok], atol=1e-7,
                                   rtol=0)


def test_fused_step_kernel_branch_matches_jax(chunk):
    Wk = bk.kernel_width(chunk["ranges"][:, 1])
    out = [x.numpy() for x in tmesh.placement_step(
        *chunk["targs"], topk=TOPK, site_width=chunk["W"], use_kernel=True,
        block_width=Wk)]
    ref = chunk["ref"]
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[5], ref[5])
    # the halved pair budget may leave live pairs uncomputed (their
    # queries re-run in the engine); every computed valid pair compares
    ok = ref[5] & (ref[6] > 0) & (out[6] > 0)
    assert ok.sum() >= 0.5 * ref[5].sum()
    np.testing.assert_allclose(out[1][ok], ref[1][ok], rtol=1e-6)
    sharp = ok & (np.abs(out[1] - ref[1]) < 1e-3)
    for i in (3, 4):
        d = np.abs(out[i] - ref[i])[sharp]
        assert np.quantile(d, 0.9) < 0.01
    # LWR over the computed pairs of fully computed rows
    rows = np.all(~ref[5] | (out[6] > 0), axis=1)
    np.testing.assert_allclose(out[2][rows], ref[2][rows], atol=1e-6)


@pytest.fixture(scope="module")
def pinv_chunk():
    """A +I chunk: evolved data with 20% of its columns made invariant
    (chip_smoke.with_invariant_sites), placed under GTR+I{0.2}+G4."""
    from chip_smoke import with_invariant_sites
    tree, ref, qry, _ = evolved_dataset(n_taxa=32, sites=160, n_queries=64,
                                        seed=2)
    freqs = (0.27, 0.23, 0.24, 0.26)
    ref, qry, cols = with_invariant_sites(ref, qry, freqs, 0.2, seed=1)
    assert len(cols) == 32
    eng = PlacementEngine(tree, ref, Model.from_string(
        "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+I{0.2}"
        "+G4{0.6}"), Options())
    ec = eng.encode_msa(qry)
    perm = np.argsort(ec.ranges[:, 0], kind="stable")
    codes, ranges = ec.codes[perm], ec.ranges[perm]
    tQ, invq = eng._query_tensors_codes(codes)
    assert np.isfinite(np.asarray(invq)).mean() > 0.05
    blo = eng.blo
    jargs = (eng.consts, eng.lookup_table, blo.tU, blo.tV, blo.ls,
             blo.lengths, jnp.asarray(codes), jnp.asarray(ranges[:, 0]),
             jnp.asarray(ranges[:, 1]), tQ, invq,
             jnp.asarray(0.99999, jnp.float64))
    consts, blo_t, table = state_from_numpy(eng.consts, blo,
                                            eng.lookup_table, device="cpu")
    targs = (consts, table, *blo_t, *(T(a) for a in jargs[6:11]), 0.99999)
    W = jmesh.chunk_site_width(ranges[:, 1], 160)
    ref_out = jmesh.placement_step(*jargs, topk=TOPK, site_width=W,
                                   use_pallas=False, has_pinv=True)
    return dict(targs=targs, W=W, ranges=ranges,
                ref=[np.asarray(x) for x in ref_out])


def test_fused_step_kernel_branch_pinv_matches_jax(pinv_chunk):
    """The kernel branch with +I (K2's call shape, the plain version on CPU
    tensors, counting its work) against the JAX step, under the rule of
    test_fused_step_kernel_branch_matches_jax."""
    chunk = pinv_chunk
    Wk = bk.kernel_width(chunk["ranges"][:, 1])
    work = bk.NewtonWork("cpu")
    out = [x.numpy() for x in tmesh.placement_step(
        *chunk["targs"], topk=TOPK, site_width=chunk["W"], use_kernel=True,
        block_width=Wk, has_pinv=True, work=work)]
    ref = chunk["ref"]
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[5], ref[5])
    ok = ref[5] & (ref[6] > 0) & (out[6] > 0)
    assert ok.sum() >= 0.5 * ref[5].sum()
    np.testing.assert_allclose(out[1][ok], ref[1][ok], rtol=1e-6)
    sharp = ok & (np.abs(out[1] - ref[1]) < 1e-3)
    for i in (3, 4):
        d = np.abs(out[i] - ref[i])[sharp]
        assert np.quantile(d, 0.9) < 0.01
    rows = np.all(~ref[5] | (out[6] > 0), axis=1)
    np.testing.assert_allclose(out[2][rows], ref[2][rows], atol=1e-6)
    # the kernel's counters reached the work tally: every computed pair
    # ran at least one smoothing of two Newton solves; the twin never ran
    tot = work.totals()
    pairs, smooth, iters = (tot[k] for k in ("newton_pairs",
                                             "newton_smoothings",
                                             "newton_iters"))
    assert pairs >= ok.sum() and smooth >= pairs and iters >= 2 * smooth
    assert tot["twin_launches"] == 0


def test_fused_step_packed_and_filtered(chunk):
    """The engine's call shape: packed, LWR-sorted and output-filtered on
    device; identical to the JAX package's twin."""
    kw = dict(topk=TOPK, site_width=chunk["W"], packed=True,
              filter_cfg=(False, 1, 7), filter_threshold=0.01)
    out = tmesh.placement_step(*chunk["targs"], **kw).numpy()
    ref = np.asarray(jmesh.placement_step(
        *chunk["jargs"], filter_threshold=jnp.asarray(0.01, jnp.float64),
        **{k: v for k, v in kw.items() if k != "filter_threshold"}))
    assert out.shape == ref.shape and out.shape[0] == 7
    np.testing.assert_array_equal(out[0], ref[0])        # edges
    np.testing.assert_array_equal(out[5], ref[5])        # keep
    np.testing.assert_array_equal(out[6], ref[6])        # flags
    keep = ref[5] > 0
    for i in (1, 2, 3, 4):
        np.testing.assert_allclose(out[i][keep], ref[i][keep], atol=1e-7,
                                   rtol=0)

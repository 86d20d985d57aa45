"""Port parity, ops layer: the PyTorch modules against their JAX
counterparts on the same seeded inputs, both in f64 on the CPU.

eigen / likelihood / clv agree to relative 1e-10; newton / lookup to 1e-8
absolute in logl and 1e-7 in branch lengths (the Newton trajectories are
the same; only the contraction order differs).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from epa_ng_tpu.models import Model
from epa_ng_tpu.ops import clv as jclv
from epa_ng_tpu.ops import eigen as jeigen
from epa_ng_tpu.ops import likelihood as jlik
from epa_ng_tpu.ops import lookup as jlookup
from epa_ng_tpu.ops import newton as jnewton
from epa_ng_tpu.models.charmaps import lookup_tip_clvs
from epa_ng_tpu.utils.synth import synth_dataset

from epa_ng_tpu_torch.models import Model as TModel
from epa_ng_tpu_torch.ops import clv as tclv
from epa_ng_tpu_torch.ops import eigen as teigen
from epa_ng_tpu_torch.ops import likelihood as tlik
from epa_ng_tpu_torch.ops import lookup as tlookup
from epa_ng_tpu_torch.ops import newton as tnewton

# one intra-op thread per test process: the suite runs in parallel
# workers, and a thread per core in each of them oversubscribes the
# CPU and slows the small tensor ops here by orders of magnitude
torch.set_num_threads(1)

GTR = "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G4{0.6}"
CPU = torch.device("cpu")


def T(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def close(a, b, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def ref_state():
    tree, ref, qry = synth_dataset(n_taxa=20, sites=96, n_queries=12, seed=4)
    model = Model.from_string(GTR)
    eig = jeigen.decompose(model)
    tip = jclv.tip_clv_matrix(tree, ref, 4)
    edges, logl = jclv.build_reference_state(tree, eig, tip)
    return dict(tree=tree, ref=ref, qry=qry, eig=eig, tip=tip, edges=edges,
                logl=logl, consts=jnewton.eig_consts(eig))


def tconsts(eig):
    return tnewton.eig_consts(teigen.decompose(TModel.from_string(GTR)),
                              torch.float64, CPU)


@pytest.mark.parametrize("model_str", [GTR, "HKY+G4", "LG+G4"])
def test_decompose_and_pmatrices(model_str):
    eig_j = jeigen.decompose(Model.from_string(model_str))
    eig_t = teigen.decompose(TModel.from_string(model_str))
    for f in ("eigenvals", "A", "Ainv", "freqs", "rates", "weights"):
        np.testing.assert_array_equal(getattr(eig_t, f), getattr(eig_j, f))
    # the zero eigenvalue the kernel skips sits at K-1, exactly 0.0
    assert eig_t.eigenvals[-1] == 0.0
    lengths = np.random.default_rng(0).gamma(1.5, 0.1, size=(7,))
    Pj = jeigen.pmatrices(eig_j, lengths)
    Pt = teigen.pmatrices(eig_t, lengths, device="cpu")
    close(Pj, Pt, rtol=1e-10, atol=1e-14)


def test_edge_loglikelihood_and_asc(ref_state):
    e = ref_state["edges"]
    eig = ref_state["eig"]
    P = jeigen.pmatrices(eig, np.asarray(e.lengths)[:1])
    args_j = (e.U[0], e.lsU[0], e.V[0], e.lsV[0], P[0],
              jnp.asarray(eig.freqs), jnp.asarray(eig.weights))
    args_t = tuple(T(a) for a in args_j)
    mask = (np.arange(96) % 3 != 0).astype(np.float64)
    inv_state = np.where(np.arange(96) % 5 == 0, 2, -1).astype(np.int32)
    inv_j = jlik.make_inv_logterm(inv_state, eig.freqs, 0.2)
    inv_t = tlik.make_inv_logterm(inv_state, eig.freqs, 0.2, device="cpu")
    close(inv_j, inv_t)
    for kw_j, kw_t in [({}, {}),
                       (dict(site_mask=jnp.asarray(mask)),
                        dict(site_mask=T(mask))),
                       (dict(pinv=0.2, inv_logterm=inv_j),
                        dict(pinv=0.2, inv_logterm=inv_t))]:
        lj = jlik.edge_loglikelihood(*args_j, **kw_j)
        lt = tlik.edge_loglikelihood(*args_t, **kw_t)
        close(lj, lt, rtol=1e-10)
    inv_l = np.log(np.array([0.01, 0.02, 0.03, 0.015]))
    w = np.array([3.0, 1.0, 2.0, 5.0])
    for kind in ("lewis", "felsenstein", "stamatakis"):
        cj = jlik.asc_bias_correction(jnp.asarray(inv_l), kind,
                                      jnp.asarray(w), 96.0)
        ct = tlik.asc_bias_correction(T(inv_l), kind, T(w), 96.0)
        close(cj, ct, rtol=1e-10)


@pytest.mark.parametrize("compressed", [False, True])
def test_build_reference_state(ref_state, compressed):
    tree, eig, tip = ref_state["tree"], ref_state["eig"], ref_state["tip"]
    weights = None
    if compressed:
        masks = jclv.tip_state_masks(tree, ref_state["ref"], 4)
        _, first, counts = np.unique(masks.T, axis=0, return_index=True,
                                     return_counts=True)
        tip, weights = tip[:, first, :], counts
    ej, lj = jclv.build_reference_state(tree, eig, tip, site_weights=weights)
    et, lt = tclv.build_reference_state(tree, teigen.decompose(
        TModel.from_string(GTR)), tip, site_weights=weights, device="cpu")
    for f in ("U", "V", "lsU", "lsV", "lengths"):
        close(getattr(ej, f), getattr(et, f), rtol=1e-10, atol=1e-300)
    assert lt == pytest.approx(lj, rel=1e-10)
    if compressed:  # pattern weights reproduce the full-width logl
        assert lt == pytest.approx(ref_state["logl"], rel=1e-10)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_compute_clvs_forms_and_edge_tensors(ref_state, dtype):
    """``compute_clvs`` against the JAX package's (f64, 1e-10), and the
    traversal's two forms: the in-place one of the placement path and the
    level-batched one that autograd runs through (``P`` requiring grad)
    give identical buffers, in f64 and f32; ``build_edge_tensors`` is the
    reference state's edge tensors."""
    tree, eig, tip = ref_state["tree"], ref_state["eig"], ref_state["tip"]
    ops = tclv.build_tree_ops(tree)
    assert sum(len(lv) for lv in tclv.op_levels(ops.ops)) == len(ops.ops)
    teig = teigen.decompose(TModel.from_string(GTR))
    P = teigen.pmatrices(teig, tree.edge_lengths, dtype=dtype, device="cpu")
    buf, ls = tclv.compute_clvs(ops, P, tip, 4)
    gbuf, gls = tclv.compute_clvs(ops, P.clone().requires_grad_(True), tip,
                                  4)
    assert gbuf.requires_grad
    assert torch.equal(gbuf.detach(), buf) and torch.equal(gls.detach(), ls)
    if dtype == torch.float64:
        jP = jeigen.pmatrices(eig, jnp.asarray(tree.edge_lengths))
        jbuf, jls = jclv.compute_clvs(jclv.build_tree_ops(tree), jP, tip, 4)
        close(jbuf, buf, rtol=1e-10, atol=1e-300)
        close(jls, ls, rtol=1e-10, atol=1e-12)
        et = tclv.build_edge_tensors(tree, teig, tip, device="cpu")
        ej = jclv.build_edge_tensors(tree, eig, tip)
        for f in ("U", "V", "lsU", "lsV", "lengths"):
            close(getattr(ej, f), getattr(et, f), rtol=1e-10, atol=1e-300)


def test_invariant_pattern_logls(ref_state):
    tree, eig = ref_state["tree"], ref_state["eig"]
    lj = jclv.invariant_pattern_logls(tree, eig)
    lt = tclv.invariant_pattern_logls(tree, teigen.decompose(
        TModel.from_string(GTR)), device="cpu")
    close(lj, lt, rtol=1e-10)


def _pairs(ref_state, P=48, seed=1):
    """Per-pair windows (JAX arrays) for P random (edge, query) pairs."""
    c, e = ref_state["consts"], ref_state["edges"]
    blo = jnewton.transform_edges(c, e.U, e.lsU, e.V, e.lsV, e.lengths)
    from epa_ng_tpu.core.chunk import col_state_masks, from_msa
    ec = from_msa(ref_state["qry"], 4)
    qmasks = col_state_masks(4)[ec.codes]
    bits = (qmasks[:, None, :] >> np.arange(4)[None, :, None]) & 1
    tQ = jnewton.transform_queries(c, jnp.asarray(bits, jnp.float64))
    rng = np.random.default_rng(seed)
    pe = rng.integers(0, e.U.shape[0], P)
    pq = rng.integers(0, len(ec), P)
    site = np.arange(96)
    r = ec.ranges[pq]
    mask = ((site[None] >= r[:, :1]) & (site[None] < r[:, :1] + r[:, 1:]))
    return blo, tQ, pe, pq, mask.astype(np.float64)


def test_transforms_and_newton_twin(ref_state):
    c, e = ref_state["consts"], ref_state["edges"]
    tc = tconsts(ref_state["eig"])
    blo, tQ, pe, pq, mask = _pairs(ref_state)
    tblo = tnewton.transform_edges(tc, T(e.U), T(e.lsU), T(e.V), T(e.lsV),
                                   T(e.lengths))
    for f in ("tU", "tV", "ls", "lengths"):
        close(getattr(blo, f), getattr(tblo, f), rtol=1e-10, atol=1e-12)
    site_map = np.random.default_rng(2).integers(0, 96, 130)
    bj = jnewton.transform_edges(c, e.U, e.lsU, e.V, e.lsV, e.lengths,
                                 jnp.asarray(site_map))
    bt = tnewton.transform_edges(tc, T(e.U), T(e.lsU), T(e.V), T(e.lsV),
                                 T(e.lengths), site_map)
    close(bj.tU, bt.tU, rtol=1e-10, atol=1e-12)
    from epa_ng_tpu.core.chunk import col_state_masks, from_msa
    ec = from_msa(ref_state["qry"], 4)
    bits = ((col_state_masks(4)[ec.codes][:, None, :]
             >> np.arange(4)[None, :, None]) & 1).astype(np.float64)
    close(jnewton.transform_queries(c, jnp.asarray(bits)),
          tnewton.transform_queries(tc, T(bits)), rtol=1e-10, atol=1e-12)

    inv = np.full(mask.shape, -np.inf)
    args = (blo.tU[pe], blo.tV[pe], tQ[pq], blo.ls[pe], mask,
            blo.lengths[pe], inv)
    out_j = jnewton.blo_optimize_batch(c, *args, sliding=True)
    out_t = tnewton.blo_optimize_batch(tc, *[T(a) for a in args])
    np.testing.assert_allclose(np.asarray(out_t[0]), np.asarray(out_j[0]),
                               atol=1e-8, rtol=0)
    for i in (1, 2, 3, 4):
        np.testing.assert_allclose(np.asarray(out_t[i]),
                                   np.asarray(out_j[i]), atol=1e-7, rtol=0)
    np.testing.assert_array_equal(out_t[5].numpy(), np.asarray(out_j[5]))


@pytest.mark.parametrize("pinv", [False, True])
def test_newton_twin_raxml_blo(ref_state, pinv):
    """The non-sliding (``--raxml-blo``) twin against the JAX package's
    ``blo_optimize_batch(sliding=False)`` on the same pairs: each
    smoothing solves the pendant, distal and proximal lengths one by one
    in [BRLEN_MIN, BRLEN_MAX]. With ``pinv`` a fifth of the in-span cells
    carry an invariant term."""
    c, tc = ref_state["consts"], tconsts(ref_state["eig"])
    blo, tQ, pe, pq, mask = _pairs(ref_state, P=64, seed=3)
    inv = np.full(mask.shape, -np.inf)
    if pinv:
        c, tc = c._replace(pinv=jnp.asarray(0.2)), tc._replace(
            pinv=torch.tensor(0.2, dtype=torch.float64))
        cells = np.random.default_rng(4).random(mask.shape) < 0.2
        inv[cells] = np.log(0.2 * 0.25)
    args = (blo.tU[pe], blo.tV[pe], tQ[pq], blo.ls[pe], mask,
            blo.lengths[pe], inv)
    out_j = jnewton.blo_optimize_batch(c, *args, sliding=False)
    out_t = tnewton.blo_optimize_batch(tc, *[T(a) for a in args],
                                       sliding=False)
    np.testing.assert_allclose(np.asarray(out_t[0]), np.asarray(out_j[0]),
                               atol=1e-8, rtol=0)
    for i in (1, 2, 3, 4):
        np.testing.assert_allclose(np.asarray(out_t[i]),
                                   np.asarray(out_j[i]), atol=1e-7, rtol=0)
    np.testing.assert_array_equal(out_t[5].numpy(), np.asarray(out_j[5]))
    # the proximal length is free: the lengths need not sum to the edge's
    sliding = tnewton.blo_optimize_batch(tc, *[T(a) for a in args])
    assert not torch.allclose(out_t[3] + out_t[4], sliding[3] + sliding[4])


@pytest.mark.parametrize("bf16", [False, True])
def test_lookup_tables_and_scores(ref_state, bf16):
    c, e = ref_state["consts"], ref_state["edges"]
    tc = tconsts(ref_state["eig"])
    chars = lookup_tip_clvs(4)
    C = chars.shape[0]
    inv = np.full((C, 96), -np.inf)
    tj = jlookup.build_lookup_tables(c, e.U, e.lsU, e.V, e.lsV, e.lengths,
                                     jnp.asarray(chars, jnp.float64),
                                     jnp.asarray(inv))
    tt = tlookup.build_lookup_tables(tc, T(e.U), T(e.lsU), T(e.V), T(e.lsV),
                                     T(e.lengths), T(chars), T(inv))
    close(tj, tt, rtol=1e-10)
    from epa_ng_tpu.core.chunk import from_msa
    ec = from_msa(ref_state["qry"], 4)
    b, s = ec.ranges[:, 0], ec.ranges[:, 1]
    if bf16:
        # the residual GEMM runs in bf16 in both packages: ranking-only
        # precision, compared at bf16's ~3 digits of the residual sum
        sj = jlookup.preplace_scores_core(
            jlookup.split_table(tj, jnp.bfloat16), jnp.asarray(ec.codes),
            jnp.asarray(b), jnp.asarray(s))
        st = tlookup.preplace_scores_core(
            tlookup.split_table(tt, torch.bfloat16), torch.as_tensor(ec.codes),
            torch.as_tensor(b), torch.as_tensor(s))
        close(sj, st, atol=0.5)
        return
    sj = jlookup.preplace_scores_core(tj, jnp.asarray(ec.codes),
                                      jnp.asarray(b), jnp.asarray(s))
    st = tlookup.preplace_scores_core(tt, torch.as_tensor(ec.codes),
                                      torch.as_tensor(b), torch.as_tensor(s))
    close(sj, st, rtol=1e-10)

"""Port parity of ``core/evaluate.py`` (``--opt-model``): the differentiable
reference-tree objective and the optimizer, against the JAX package's on the
same seeded data, f64 on the CPU.

- ``_neg_logl``: the value to 1e-10 relative, the gradient to 1e-8 relative
  where the symmetrised rate matrix has distinct eigenvalues. At repeated
  eigenvalues (the generic start: equal exchangeabilities, uniform
  frequencies) ``jax.grad`` through ``jnp.linalg.eigh`` returns finite
  numbers that are not the objective's gradient in the rate and frequency
  directions; there the port's gradient is held against central
  differences of the JAX objective, and its branch-length part against
  ``jax.grad``, which does not go through the eigenvectors.
- ``optimize_model``: the optimum within OPT_EPSILON log-units of the JAX
  package's (two L-BFGS implementations take other paths to it), the
  reported logl equal to the engine's at the written-back parameters, and
  the parameters the model fixes left as they were.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epa_ng_tpu.core import evaluate as jev
from epa_ng_tpu.models import Model as JModel
from epa_ng_tpu.ops import clv as jclv
from epa_ng_tpu.utils.synth import evolved_dataset

from epa_ng_tpu_torch.core import evaluate as tev
from epa_ng_tpu_torch.core.engine import PlacementEngine
from epa_ng_tpu_torch.io.fasta import MSA
from epa_ng_tpu_torch.models import Model as TModel
from epa_ng_tpu_torch.models.gamma import discrete_gamma_rates
from epa_ng_tpu_torch.models.model import ParamValue
from epa_ng_tpu_torch.tree import Tree
from epa_ng_tpu_torch.utils.options import Options

# one intra-op thread per test process: the suite runs in parallel
# workers, and a thread per core in each of them oversubscribes the
# CPU and slows the small tensor ops here by orders of magnitude
torch.set_num_threads(1)

GT_ALPHABET = "ACGTMRSWYK"  # pll_map_diploid10's state order


def _data(alphabet="ACGT", model_str=None, n_taxa=16, sites=120):
    tree, ref, _, _ = evolved_dataset(n_taxa=n_taxa, sites=sites,
                                      n_queries=1, seed=3,
                                      model_str=model_str, alphabet=alphabet)
    return tree, ref


def _port(tree, ref):
    out = MSA()
    for s in ref:
        out.append(s.header, s.sequence)
    return Tree.from_string(tree.plain_newick()), out


def _objective_args(tree, ref, model, pinv):
    """Every argument of both packages' ``_neg_logl`` but the three L-BFGS
    variables, as numpy (the constants) and a dict of starts."""
    K = model.num_states
    ops = jclv.build_tree_ops(tree)
    tip = jclv.tip_clv_matrix(tree, ref, K)
    n_free, expand = jev._rate_expander(model)
    basis = np.stack([np.asarray(expand(jnp.asarray(np.eye(n_free)[i])))
                      for i in range(n_free)])
    masks = jclv.tip_state_masks(tree, ref, K)
    inv_state = jclv.invariant_states(masks, K)
    n_real = ref.num_sites
    if model.ascbias_type is not None:
        tip = np.concatenate(
            [tip, np.broadcast_to(np.eye(K)[None], (tree.n_tips, K, K))],
            axis=1)
        inv_state = np.concatenate([inv_state, np.full(K, -1, np.int32)])
    const = dict(
        pinv_logit=np.array(np.log(pinv) - np.log1p(-pinv)),
        rate_basis=basis, ops_arr=np.asarray(ops.ops),
        u0=int(ops.u_idx[0]), v0=int(ops.v_idx[0]), tip_clvs=tip,
        cat_rates=discrete_gamma_rates(model.alpha, model.num_ratecats,
                                       model.gamma_mode),
        cat_weights=np.asarray(model.ratecat_weights),
        inv_state=inv_state, asc_w=np.zeros(K))
    static = dict(n_clvs=ops.n_clvs, asc_kind=model.ascbias_type,
                  n_real=n_real)
    return const, static, n_free


def _jax_value_and_grad(const, static, x):
    def f(lb, lu, fl):
        c = {k: (v if k in ("u0", "v0") else jnp.asarray(v))
             for k, v in const.items()}
        return jev._neg_logl(lb, lu, fl, **c, **static)
    v, g = jax.value_and_grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in x))
    return float(v), [np.asarray(a) for a in g]


def _port_value_and_grad(const, static, x):
    T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    xs = [T(a).requires_grad_(True) for a in x]
    c = dict(const)
    c["inv_state"] = torch.as_tensor(c["inv_state"], dtype=torch.long)
    c = {k: (v if k in ("u0", "v0", "ops_arr", "inv_state") else T(v))
         for k, v in c.items()}
    v = tev._neg_logl(*xs, **c, **static)
    v.backward()
    return v.item(), [a.grad.numpy() for a in xs]


@pytest.mark.parametrize("model_str,alphabet,pinv", [
    ("GTR+G4{0.7}", "ACGT", 1e-12),
    ("GTR+G4{0.7}+ASC_LEWIS", "ACGT", 1e-12),
    ("GTR+G4{0.7}+I{0.2}", "ACGT", 0.2),
    ("GTGTR4+G4{0.7}", GT_ALPHABET, 1e-12)])
def test_neg_logl_value_and_gradient_match_jax(model_str, alphabet, pinv):
    """The objective and its gradient at a random point with distinct
    eigenvalues (rates and frequencies drawn from a seed): value 1e-10,
    gradient 1e-8 relative to its largest entry, in every variable."""
    gen = None if alphabet == "ACGT" else (
        "GTGTR4{1.5/2.5/0.8/1.2/3.0/1.0}+FE+G4{0.8}")
    tree, ref = _data(alphabet, gen, n_taxa=12, sites=80)
    model = JModel.from_string(model_str)
    const, static, n_free = _objective_args(tree, ref, model, pinv)
    rng = np.random.default_rng(5)
    x = (np.log(tree.edge_lengths) + 0.2 * rng.standard_normal(
        tree.n_edges),
         rng.uniform(-1.0, 1.0, n_free),
         rng.uniform(-0.5, 0.5, model.num_states))
    vj, gj = _jax_value_and_grad(const, static, x)
    vt, gt = _port_value_and_grad(const, static, x)
    assert vt == pytest.approx(vj, rel=1e-10)
    for a, b in zip(gj, gt):
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-8 * np.abs(a).max())


def test_neg_logl_gradient_at_repeated_eigenvalues():
    """At the generic GTR+G start the symmetrised Q has repeated
    eigenvalues. The port's gradient is finite there and is the
    objective's: central differences of the JAX objective in the rate and
    frequency directions, ``jax.grad`` in the branch lengths. The JAX
    package's gradient in the rate and frequency directions is not the
    objective's there (``eigh``'s derivative divides by the eigenvalue
    gaps); the port's divided differences keep it exact."""
    tree, ref = _data()
    model = JModel.from_string("GTR+G")
    const, static, n_free = _objective_args(tree, ref, model, 1e-12)
    uniq = np.asarray([model.subst_rates[i] for i in range(n_free)])
    x = (np.log(tree.edge_lengths), np.log(uniq), np.log(model.base_freqs))
    vj, gj = _jax_value_and_grad(const, static, x)
    vt, gt = _port_value_and_grad(const, static, x)
    assert vt == pytest.approx(vj, rel=1e-10)
    assert all(np.isfinite(g).all() for g in gt)
    np.testing.assert_allclose(gt[0], gj[0], rtol=0,
                               atol=1e-8 * np.abs(gj[0]).max())

    def value(lu, fl):
        return _jax_value_and_grad(const, static, (x[0], lu, fl))[0]
    h = 1e-6
    for i, n in ((1, n_free), (2, model.num_states)):
        fd = []
        for j in range(n):
            step = [np.array(x[1]), np.array(x[2])]
            step[i - 1][j] += h
            up = value(*step)
            step[i - 1][j] -= 2 * h
            fd.append((up - value(*step)) / (2 * h))
        fd = np.asarray(fd)
        np.testing.assert_allclose(gt[i], fd, rtol=1e-6, atol=1e-5)
        assert np.abs(gj[i] - fd).max() > 1.0   # the JAX gradient there


def _engine_logl(tree, ref, model):
    return PlacementEngine(tree, ref, model,
                           Options(premasking=False), device="cpu"
                           ).ref_tree_logl


@pytest.mark.parametrize("model_str", [
    "GTR+G",
    "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G4",
    "HKY+G4{0.6}+I"])
def test_optimize_model_optimum_matches_jax(model_str):
    """f64 on 16 taxa x 120 sites: the port's optimum within OPT_EPSILON
    of the JAX package's, never below its start; the reported logl is the
    port engine's at the written-back tree and model; rates and
    frequencies the model fixes stay fixed, and what is free moves."""
    tree, ref = _data()
    ttree, tref = _port(tree, ref)
    bl0 = ttree.edge_lengths.copy()
    jm, tm = JModel.from_string(model_str), TModel.from_string(model_str)
    lj = jev.optimize_model(tree, ref, jm)
    stats = {}
    lt = tev.optimize_model(ttree, tref, tm, device="cpu", stats=stats)
    assert abs(lt - lj) <= tev.OPT_EPSILON
    assert lt > stats["start_logl"]
    assert stats["final_logl"] == lt
    assert _engine_logl(ttree, tref, tm) == pytest.approx(lt, rel=1e-10)
    start = TModel.from_string(model_str)
    for name, mode in (("subst_rates", start.rates_mode),
                       ("base_freqs", start.freqs_mode)):
        moved = not np.allclose(getattr(tm, name), getattr(start, name))
        assert moved == (mode == ParamValue.ML), name
    if "+I" in model_str:
        assert 0.0 < tm.pinv < 1.0
        assert tm.pinv == pytest.approx(jm.pinv, abs=0.05)
    assert tm.alpha == pytest.approx(jm.alpha, rel=0.1)
    assert not np.allclose(ttree.edge_lengths, bl0)

"""ML evaluation of model parameters + reference-tree branch lengths
(``--opt-model``).

The analog of the reference's all-params ``optimize()``
(src/core/pll/optimize.cpp:329-455: empirical freqs, then a loop of
substitution-rate optimization -> full-tree branch-length optimization ->
alpha Brent search until the log-likelihood improvement drops below
OPT_EPSILON), formulated as the JAX package's ``core/evaluate.py`` does:
branch lengths, substitution rates and (optionally) base frequencies move
jointly by L-BFGS on the reference-tree log-likelihood through autograd —
the whole likelihood (eigendecomposition, P(t), CLV traversal, edge logl)
is differentiable — while the Gamma shape alpha (whose discretization runs
through incomplete-gamma quantiles on the host) and the proportion of
invariant sites alternate in an outer golden-section search.

Two pieces differ from the JAX package's, as torch requires:

- P(t) runs through :class:`_ExpSym`, whose backward is the
  divided-difference (Daleckii-Krein) form of the matrix exponential's
  derivative: ``torch.linalg.eigh``'s own backward divides by eigenvalue
  gaps and returns NaN at repeated eigenvalues, which the generic start
  (equal exchangeabilities, uniform frequencies) has;
- the optimizer is ``torch.optim.LBFGS`` with a strong-Wolfe line search
  (``optax.lbfgs`` in the JAX package), one iteration per step, followed
  by the same ``nan_to_num`` and clips.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from epa_ng_tpu_torch.models.gamma import discrete_gamma_rates
from epa_ng_tpu_torch.models.model import ParamValue, _gt_expand, _n_rates
from epa_ng_tpu_torch.ops import clv as clv_ops
from epa_ng_tpu_torch.ops import likelihood

log = logging.getLogger("epa_ng_tpu_torch")

OPT_EPSILON = 1.0  # outer-loop convergence (reference optimize.cpp:342)
MIN_BL, MAX_BL = 1e-6, 100.0
MIN_RATE, MAX_RATE = 1e-3, 1e3
ALPHA_MIN, ALPHA_MAX = 0.02, 100.0
PINV_LOGIT_MIN, PINV_LOGIT_MAX = -13.8, 2.2
# the L-BFGS round: a loss plateau is checked every CHECK steps
CHECK, INNER_EPS = 20, OPT_EPSILON / 10.0
# optax.lbfgs's defaults: memory size, and the most steps of its zoom
# line search
LBFGS_MEMORY = 10
LINESEARCH_STEPS = 20


def _rate_expander(model):
    """(n_free, basis): the [n_free, NR] 0/1 matrix that expands the free
    exchangeabilities to the full upper-triangle vector, honoring the
    model's symmetry (genotype models: through the 45-rate expansion)."""
    if model.gt_dna_sym is not None:
        idx = np.asarray([int(c) for c in model.gt_dna_sym])
        n = max(idx) + 1
        # structural zeros of the genotype expansion, as a 0/1 matrix
        # applied to the expanded 6-vector
        return n, np.stack([_gt_expand((idx == i).astype(np.float64))
                            for i in range(n)])
    if model.rate_sym is not None:
        idx = np.asarray([int(c) for c in model.rate_sym])
        n = max(idx) + 1
        return n, (idx[None, :] == np.arange(n)[:, None]).astype(np.float64)
    nr = _n_rates(model.num_states)
    return nr, np.eye(nr)


class _ExpSym(torch.autograd.Function):
    """exp(t B) for a symmetric B [K, K] and times t [...]: W exp(t Lambda)
    W^T with B = W Lambda W^T, as [..., K, K].

    The backward is the Daleckii-Krein form of the Frechet derivative of
    f(B) = exp(t B): with G the output's gradient and G~ = W^T G W,

        dB = sum_t W (F_t o G~_t) W^T,
        F_t[i, j] = (e^{t l_i} - e^{t l_j}) / (l_i - l_j),   t e^{t l_i} at i = j
                  = t e^{t l_j} expm1(x) / x,   x = t (l_i - l_j),

    and dt = sum_i G~[i, i] l_i e^{t l_i}. The divided difference stays
    finite (its limit t e^{t l}) where eigenvalues repeat, and expm1 keeps
    it accurate where they nearly do."""

    @staticmethod
    def forward(ctx, B, t):
        lam, W = torch.linalg.eigh(B)
        e = torch.exp(t[..., None] * lam)                   # [..., K]
        ctx.save_for_backward(lam, W, t, e)
        return torch.einsum("ik,...k,jk->...ij", W, e, W)

    @staticmethod
    def backward(ctx, G):
        lam, W, t, e = ctx.saved_tensors
        Gt = torch.einsum("ki,...kl,lj->...ij", W, G, W)
        x = t[..., None, None] * (lam[:, None] - lam[None, :])
        zero = x == 0
        phi = torch.where(zero, torch.ones_like(x),
                          torch.expm1(x) / torch.where(zero,
                                                       torch.ones_like(x), x))
        F = t[..., None, None] * e[..., None, :] * phi
        FG = (F * Gt).reshape(-1, *Gt.shape[-2:]).sum(0)
        gB = W @ FG @ W.T
        gt = torch.einsum("...ii,i,...i->...", Gt, lam, e)
        return gB, gt


def _neg_logl(log_bl, log_uniq, freq_logits, pinv_logit, rate_basis,
              ops_arr, u0, v0, tip_clvs, cat_rates, cat_weights, inv_state,
              asc_w, n_clvs: int, asc_kind=None, n_real=0):
    """Differentiable reference-tree negative log-likelihood.

    rate_basis: [n_free, NR] expansion matrix from free rates to the full
    exchangeability vector; u0/v0: the CLV indices of edge 0's endpoints;
    pinv_logit: scalar, sigmoid -> proportion of invariant sites (pass
    -inf-ish for pinv == 0); inv_state: [S] invariant state index or -1.
    The proportion of invariant sites is never an L-BFGS variable (it
    alternates by golden section), so the edge logl takes it as a number.
    """
    dtype = tip_clvs.dtype
    K = tip_clvs.shape[2]
    rates_full = torch.exp(log_uniq) @ rate_basis
    freqs = torch.softmax(freq_logits, dim=0)
    pinv = torch.sigmoid(pinv_logit)
    # Q build (ops.eigen.build_rate_matrix, differentiably)
    iu = torch.triu_indices(K, K, offset=1, device=tip_clvs.device)
    S = torch.zeros((K, K), dtype=dtype, device=tip_clvs.device)
    S = S.index_put((iu[0], iu[1]), rates_full)
    S = S + S.T
    Q = S * freqs[None, :]
    Q = Q - torch.diag(torch.sum(Q, dim=1))
    scale = -torch.sum(freqs * torch.diagonal(Q))
    Q = Q / scale
    sqrt_pi = torch.sqrt(freqs)
    B = sqrt_pi[:, None] * Q / sqrt_pi[None, :]
    B = (B + B.T) / 2

    bl = torch.exp(log_bl)
    # libpll convention: time scaled by 1/(1-pinv) (ops.eigen.pmatrices)
    t = bl[:, None] * cat_rates / (1.0 - pinv)               # [E, R]
    # P(t) = diag(1/sqrt(pi)) exp(t B) diag(sqrt(pi)) = A exp(t L) A^-1
    P = torch.clamp(_ExpSym.apply(B, t) * (sqrt_pi[None, :]
                                           / sqrt_pi[:, None]), min=0.0)

    buf, ls = clv_ops._compute_clvs_core(ops_arr, P, tip_clvs, n_clvs,
                                         cat_rates.shape[0])
    inv_logterm = torch.where(
        inv_state >= 0,
        torch.log(pinv * freqs[torch.clamp(inv_state, min=0)]),
        torch.full_like(P[0, 0, 0, :1], -torch.inf))
    persite = likelihood.edge_logl_persite(
        buf[u0], ls[u0], buf[v0], ls[v0], P[0], freqs, cat_weights,
        pinv=float(pinv), inv_logterm=inv_logterm)
    if asc_kind is None:
        logl = torch.sum(persite)
    else:
        # the last K pseudo-sites are the dummy invariant columns
        # (ASC + pinv is rejected at parse, so inv_logterm is inert here)
        logl = torch.sum(persite[:n_real]) + likelihood.asc_bias_correction(
            persite[n_real:], asc_kind, asc_w, n_real)
    return -logl


def _golden_section(f, lo, hi, tol=1e-3, max_iters=40):
    """Scalar minimizer (the role of pllmod's Brent for alpha)."""
    gr = (np.sqrt(5.0) - 1) / 2
    a, b = lo, hi
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(max_iters):
        if abs(b - a) < tol * (abs(a) + abs(b)):
            break
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = f(d)
    return (c, fc) if fc < fd else (d, fd)


def optimize_model(tree, ref_msa, model, dtype=torch.float64,
                   lbfgs_steps: int = 200, device="cuda",
                   stats: dict | None = None) -> float:
    """Optimize free parameters in place; returns the final logl.

    Moves: branch lengths (always), substitution rates (rates_mode == ML),
    base frequencies (freqs_mode == ML), alpha (gamma with alpha_mode ML)
    and the proportion of invariant sites (pinv_mode ML or empirical).
    Updates ``tree.edge_lengths`` and the model fields. ``stats``, when
    given, receives the starting and final logl, the outer rounds, the
    L-BFGS steps and the objective's evaluations with and without its
    gradient.
    """
    if getattr(model, "submodels", None):
        raise ValueError(
            "--opt-model does not support matrix-mixture models "
            "(LG4M/LG4X); their matrices are fixed model data")
    dev = torch.device(device)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    ops = clv_ops.build_tree_ops(tree)
    tip_np = clv_ops.tip_clv_matrix(tree, ref_msa, model.num_states)
    u0 = int(ops.u_idx[0])
    v0 = int(ops.v_idx[0])

    n_free, basis = _rate_expander(model)
    basis_t = as_t(basis)

    opt_rates = model.rates_mode == ParamValue.ML
    opt_freqs = model.freqs_mode == ParamValue.ML
    opt_alpha = (model.rate_het == "gamma" and model.num_ratecats > 1
                 and model.alpha_mode in (ParamValue.ML,
                                          ParamValue.UNDEFINED))
    opt_pinv = model.pinv_mode in (ParamValue.ML, ParamValue.EMPIRICAL)

    # invariant-site states (for the p-inv mixture term)
    if model.pinv > 0 or opt_pinv:
        masks = clv_ops.tip_state_masks(tree, ref_msa, model.num_states)
        inv_state = clv_ops.invariant_states(masks, model.num_states)
    else:
        inv_state = np.full(ref_msa.num_sites, -1, np.int32)

    n_real = ref_msa.num_sites
    asc_kind = model.ascbias_type
    K = model.num_states
    if asc_kind is not None:
        # append the K dummy invariant columns as extra sites so the
        # correction rides the same (differentiable) traversal
        eyecols = np.broadcast_to(np.eye(K)[None], (tree.n_tips, K, K))
        tip_np = np.concatenate([tip_np, eyecols], axis=1)
        inv_state = np.concatenate([inv_state, np.full(K, -1, np.int32)])
    tip_clvs = as_t(tip_np)
    asc_w = as_t(model.ascbias_weights if model.ascbias_weights is not None
                 else np.zeros(K))
    inv_state_t = torch.as_tensor(inv_state, dtype=torch.long, device=dev)

    # initial parameters
    uniq0 = np.zeros(n_free)
    if model.rate_sym is not None:
        for pos, c in enumerate(model.rate_sym):
            uniq0[int(c)] = model.subst_rates[pos]
    elif model.gt_dna_sym is not None:
        uniq0[:] = 1.0
    else:
        uniq0[:] = model.subst_rates[:n_free]
    pinv0 = float(model.pinv) if model.pinv > 0 else (
        0.1 if opt_pinv else 1e-12)
    init_all = {
        "log_bl": as_t(np.log(np.clip(tree.edge_lengths, MIN_BL, MAX_BL))),
        "log_uniq": as_t(np.log(np.clip(uniq0, MIN_RATE, MAX_RATE))),
        "freq_logits": as_t(np.log(model.base_freqs)),
        "pinv_logit": as_t(np.log(pinv0) - np.log1p(-pinv0)),
    }
    # pinv alternates as a bounded scalar (like alpha; the reference uses
    # EM/Brent for it): joint L-BFGS in the pinv direction is numerically
    # fragile. Fixed parameters are constants, NOT zero-gradient entries of
    # the optimization variables: L-BFGS curvature estimates and line
    # searches move zero-gradient coordinates anyway.
    frozen = {k for k, on in
              [("log_uniq", opt_rates), ("freq_logits", opt_freqs)]
              if not on} | {"pinv_logit"}
    fixed = {k: v for k, v in init_all.items() if k in frozen}
    params = {k: v.clone().requires_grad_(True)
              for k, v in init_all.items() if k not in frozen}

    alpha = float(model.alpha)
    weights = as_t(model.ratecat_weights)

    def cat_rates_for(a: float):
        if model.rate_het == "gamma" and model.num_ratecats > 1:
            r = discrete_gamma_rates(a, model.num_ratecats, model.gamma_mode)
        else:
            r = np.asarray(model.ratecat_rates)
        return as_t(r)

    clips = {"log_bl": (np.log(MIN_BL), np.log(MAX_BL)),
             "log_uniq": (np.log(MIN_RATE), np.log(MAX_RATE)),
             # keep pinv in (1e-6, 0.9): near 1 the 1/(1-pinv) time
             # scaling overflows exp() and the loss goes numerically bogus
             "pinv_logit": (PINV_LOGIT_MIN, PINV_LOGIT_MAX),
             # frequencies live through softmax; bound the logits only
             # against runaway drift
             "freq_logits": (-30.0, 30.0)}

    def loss_fn(p, cat_rates):
        q = {**fixed, **p}
        return _neg_logl(q["log_bl"], q["log_uniq"], q["freq_logits"],
                         q["pinv_logit"], basis_t, ops.ops, u0, v0,
                         tip_clvs, cat_rates, weights, inv_state_t, asc_w,
                         n_clvs=ops.n_clvs, asc_kind=asc_kind,
                         n_real=n_real)

    count = dict(rounds=0, lbfgs_steps=0, grad_evals=0, value_evals=0)

    def value(p, cat_rates) -> float:
        count["value_evals"] += 1
        with torch.no_grad():
            return float(loss_fn(p, cat_rates))

    def lbfgs_round(cat_rates, steps):
        # one iteration a step; max_eval bounds the step's evaluations,
        # the line search's among them (its default, 5/4 of max_iter,
        # would leave the line search none)
        opt = torch.optim.LBFGS(
            list(params.values()), lr=1.0, max_iter=1,
            max_eval=1 + LINESEARCH_STEPS, history_size=LBFGS_MEMORY,
            line_search_fn="strong_wolfe")

        def closure():
            count["grad_evals"] += 1
            opt.zero_grad()
            loss = loss_fn(params, cat_rates)
            loss.backward()
            return loss

        # early stop on loss plateau, checked every CHECK steps: the
        # reference's inner optimizers carry their own epsilons too (pllmod
        # opt, optimize.cpp:329-455), and on big trees the fixed 200-step
        # round is mostly plateau
        val = prev = None
        for i in range(steps):
            val = opt.step(closure).item()   # the loss before the step
            count["lbfgs_steps"] += 1
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(torch.clamp(torch.nan_to_num(v), *clips[k]))
            if (i + 1) % CHECK == 0:
                if prev is not None and abs(prev - val) < INNER_EPS:
                    break
                prev = val
        return val

    neg = start = value(params, cat_rates_for(alpha))
    log.info("Optimization: starting logl %.6f", -neg)

    for round_i in range(10):  # outer loop (reference optimize.cpp:337-452)
        count["rounds"] += 1
        neg_new = lbfgs_round(cat_rates_for(alpha), lbfgs_steps)
        if opt_alpha:
            alpha, neg_new = _golden_section(
                lambda a: value(params, cat_rates_for(a)), ALPHA_MIN,
                ALPHA_MAX)
        if opt_pinv:
            cat = cat_rates_for(alpha)

            def pinv_obj(logit):
                fixed["pinv_logit"] = as_t(logit)
                return value(params, cat)
            logit, neg_new = _golden_section(pinv_obj, PINV_LOGIT_MIN,
                                             PINV_LOGIT_MAX)
            fixed["pinv_logit"] = as_t(logit)
        if abs(neg - neg_new) < OPT_EPSILON:
            neg = neg_new
            break
        neg = neg_new
        log.info("Optimization round %d: logl %.6f (alpha %.4f)",
                 round_i + 1, -neg, alpha)

    # write back
    host = lambda t: t.detach().cpu().numpy().astype(np.float64)
    with torch.no_grad():
        tree.edge_lengths = host(torch.exp(params["log_bl"]))
        if opt_rates:
            full = np.exp(host(params["log_uniq"])) @ basis
            model.subst_rates = full / (full[-1] if full[-1] else 1.0)
        if opt_freqs:
            f = np.exp(host(params["freq_logits"]))
            model.base_freqs = f / f.sum()
        if opt_pinv:
            model.pinv = float(torch.sigmoid(fixed["pinv_logit"]))
    if opt_alpha:
        model.set_alpha(alpha)
    # recompute the final logl from the written-back state so the reported
    # value is exactly the model the engine will use
    neg = value(params, cat_rates_for(alpha))
    log.info("Optimized model: %s, logl %.6f", model.to_string(), -neg)
    if stats is not None:
        stats.update(start_logl=-start, final_logl=-neg, **count)
    return -neg

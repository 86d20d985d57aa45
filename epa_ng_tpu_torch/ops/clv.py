"""Conditional likelihood vectors (CLVs) for every edge of the reference tree.

Two-pass formulation of libpll's partial traversals (reference:
src/core/pll/epa_pll_util.cpp:62-107 ``precompute_clvs``):

- **up pass** (postorder): D[n -> parent] for every non-root node,
- **down pass** (preorder): D[parent -> n] for every node,

where D[a -> b] is the conditional likelihood at ``a`` of everything behind
``a`` seen from ``b``. Both passes run one static operations list; each op
contracts two child CLVs with their edge transition matrices, and
underflow is handled by per-(rate, site) renormalization with a log-scale
accumulator (replacing libpll scaler buffers).

Every edge then has its two directional CLVs as gathers from the buffer:
``U[e] = D[parent(e) -> child(e)]`` (rest-of-tree) and
``V[e] = D[child(e) -> parent(e)]`` (subtree below the edge).

The numpy helpers (schedule, tip CLVs, state masks) are copies of the JAX
package's; the traversal itself is torch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from epa_ng_tpu_torch.models.charmaps import encode_states, mask_to_clv_rows
from epa_ng_tpu_torch.ops import likelihood
from epa_ng_tpu_torch.ops.eigen import EigenModel, pmatrices
from epa_ng_tpu_torch.tree.tree import Tree


@dataclass
class TreeOps:
    """Static CLV schedule + edge -> directed-CLV index maps."""
    n_tips: int
    n_clvs: int
    ops: np.ndarray      # [n_ops, 5] int32: out, in1, edge1, in2, edge2
    u_idx: np.ndarray    # [E] proximal-direction CLV index per edge
    v_idx: np.ndarray    # [E] distal-direction CLV index per edge


def build_tree_ops(tree: Tree) -> TreeOps:
    T = tree.n_tips
    vroot = tree.vroot

    def didx(n: int, toward: int) -> int:
        """Directed CLV index for D[n -> toward]."""
        if n < T:
            return n  # tips have a single (up) CLV
        neighbors = ([] if n == vroot else [int(tree.node_parent[n])])
        neighbors += tree.node_children[n]
        d = neighbors.index(toward)
        return T + 3 * (n - T) + d

    up_ops = []

    def up(n: int):
        for c in tree.node_children[n]:
            up(c)
        if n == vroot or n < T:
            return
        c0, c1 = tree.node_children[n]
        up_ops.append((didx(n, int(tree.node_parent[n])),
                       didx(c0, n), int(tree.node_edge[c0]),
                       didx(c1, n), int(tree.node_edge[c1])))

    for c in tree.node_children[vroot]:
        up(c)

    down_ops = []

    def down(n: int):
        # D[n -> x] for each child x of n
        if n == vroot:
            neighbors = list(tree.node_children[n])
        else:
            neighbors = [int(tree.node_parent[n])] + tree.node_children[n]
        for x in tree.node_children[n]:
            ins = []
            for y in neighbors:
                if y == x:
                    continue
                if y == tree.node_parent[n] and n != vroot:
                    ins.append((didx(y, n), int(tree.node_edge[n])))
                else:
                    ins.append((didx(y, n), int(tree.node_edge[y])))
            (i1, e1), (i2, e2) = ins
            down_ops.append((didx(n, x), i1, e1, i2, e2))
        for x in tree.node_children[n]:
            down(x)

    down(vroot)

    ops = np.asarray(up_ops + down_ops, dtype=np.int32)

    E = tree.n_edges
    u_idx = np.zeros(E, dtype=np.int32)
    v_idx = np.zeros(E, dtype=np.int32)
    for e in range(E):
        c = int(tree.edge_child[e])
        p = int(tree.edge_parent[e])
        v_idx[e] = didx(c, p)
        u_idx[e] = didx(p, c)

    n_clvs = T + 3 * tree.n_inner
    return TreeOps(n_tips=T, n_clvs=n_clvs, ops=ops, u_idx=u_idx, v_idx=v_idx)


def tip_clv_matrix(tree: Tree, msa, num_states: int) -> np.ndarray:
    """[tips, sites, states] multi-hot tip CLVs, linking MSA rows to tree tips
    by label (reference: src/core/pll/epa_pll_util.cpp:10-60)."""
    by_label = {}
    for s in msa:
        by_label[s.header] = s.sequence
    sites = msa.num_sites
    out = np.zeros((tree.n_tips, sites, num_states), dtype=np.float64)
    missing = []
    for t, label in enumerate(tree.labels):
        seq = by_label.get(label)
        if seq is None:
            missing.append(label)
            continue
        out[t] = mask_to_clv_rows(encode_states(seq, num_states), num_states)
    if missing:
        raise ValueError(
            "The reference Tree contained taxa that could not be found in "
            f"the reference MSA: {', '.join(missing)}")
    return out


def tip_state_masks(tree: Tree, msa, num_states: int) -> np.ndarray:
    """[tips, sites] uint32 per-site state bitmask per tip (for invariant
    site detection)."""
    by_label = {s.header: s.sequence for s in msa}
    sites = msa.num_sites
    out = np.zeros((tree.n_tips, sites), dtype=np.uint32)
    missing = []
    for t, label in enumerate(tree.labels):
        seq = by_label.get(label)
        if seq is None:  # same error as tip_clv_matrix (epa_pll_util.cpp
            missing.append(label)  # link_tree_msa missing-taxa semantics)
            continue
        out[t] = encode_states(seq, num_states)
    if missing:
        raise ValueError(
            "The reference Tree contained taxa that could not be found in "
            f"the reference MSA: {', '.join(missing)}")
    return out


def invariant_states(masks: np.ndarray, num_states: int) -> np.ndarray:
    """Per-site invariant state index, -1 where not invariant: a site is
    invariant iff the intersection of all tip state sets is a single state
    (libpll ``pll_update_invariant_sites`` semantics)."""
    inter = masks[0].copy()
    for row in masks[1:]:
        inter &= row
    popcount = np.zeros_like(inter)
    tmp = inter.copy()
    while tmp.any():
        popcount += tmp & 1
        tmp >>= 1
    state = np.full(inter.shape, -1, dtype=np.int32)
    single = popcount == 1
    if single.any():
        state[single] = np.log2(inter[single]).astype(np.int32)
    return state


def compute_clvs(ops: TreeOps, P: torch.Tensor, tip_clvs, num_rates: int):
    """Run the traversal; returns (buffer [C,R,K,S], logscale [C,R,S]).
    Sites ride the last axis, as in every CLV tensor of the package."""
    return _compute_clvs_core(
        ops.ops, P, torch.as_tensor(np.asarray(tip_clvs), dtype=P.dtype,
                                    device=P.device),
        ops.n_clvs, num_rates)


def _clv_op(P1, P2, c1, c2, ls1, ls2):
    """Ops of the traversal: parent CLVs from two child CLVs and their
    edges' P matrices, rescaled per (rate, site); returns (clv [..., R, K,
    S], log scale [..., R, S]) for one op or a batch of them."""
    clv = torch.matmul(P1, c1) * torch.matmul(P2, c2)
    # per-(site, rate) rescaling: the analog of libpll's
    # PLL_ATTRIB_RATE_SCALERS. Joint per-site scaling underflows the slow
    # gamma categories in f32 on deep trees (each category's scale drifts
    # apart along the tree), which silently corrupts logls.
    scale = torch.amax(clv, dim=-2)                         # [..., R, S]
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return clv / safe[..., None, :], ls1 + ls2 + torch.log(safe)


def op_levels(ops_arr: np.ndarray) -> list:
    """The ops of a schedule grouped into levels, in order: an op's level
    is one more than its inputs' highest (tips are level 0), so the ops of
    one level depend only on earlier levels."""
    ops = np.asarray(ops_arr)
    if not len(ops):
        return []
    level = np.zeros(int(ops[:, [0, 1, 3]].max()) + 1, dtype=np.int64)
    lv = np.empty(len(ops), dtype=np.int64)
    for k, (out, i1, _, i2, _) in enumerate(ops.tolist()):
        lv[k] = level[out] = max(level[i1], level[i2]) + 1
    return [ops[lv == v] for v in range(1, int(lv.max()) + 1)]


def _compute_clvs_core(ops_arr: np.ndarray, P: torch.Tensor,
                       tip_clvs: torch.Tensor, n_clvs: int, num_rates: int):
    """The traversal (the JAX package's ``lax.scan`` over ``ops_arr``).
    Returns (buffer [C,R,K,S], logscale [C,R,S]); sites ride the last
    axis.

    Without autograd, one Python step per op writes into preallocated
    buffers in place. When a gradient is wanted (``P`` or the tips require
    grad, as in ``core.evaluate``) autograd cannot run through those
    writes: the ops then run level by level (:func:`op_levels`), each
    level one batched ``_clv_op`` whose CLVs are written out of place
    (``index_copy``), which also launches one batch per level instead of
    one op at a time. The two forms do the same arithmetic per op; the
    batched matmuls may round in another order."""
    T, S, K = tip_clvs.shape
    dev = P.device
    tips = tip_clvs.permute(0, 2, 1)[:, None, :, :].expand(
        T, num_rates, K, S)
    if torch.is_grad_enabled() and (P.requires_grad
                                    or tip_clvs.requires_grad):
        buf = torch.cat([tips, torch.zeros((n_clvs - T, num_rates, K, S),
                                           dtype=P.dtype, device=dev)])
        ls = torch.zeros((n_clvs, num_rates, S), dtype=P.dtype, device=dev)
        for lvl in op_levels(ops_arr):
            out, i1, e1, i2, e2 = torch.as_tensor(
                lvl.T, dtype=torch.long, device=dev)
            clv, lsc = _clv_op(P[e1], P[e2], buf[i1], buf[i2], ls[i1],
                               ls[i2])
            buf = buf.index_copy(0, out, clv)
            ls = ls.index_copy(0, out, lsc)
        return buf, ls
    buf = torch.zeros((n_clvs, num_rates, K, S), dtype=P.dtype, device=dev)
    buf[:T] = tips
    ls = torch.zeros((n_clvs, num_rates, S), dtype=P.dtype, device=dev)
    for out, i1, e1, i2, e2 in np.asarray(ops_arr).tolist():
        buf[out], ls[out] = _clv_op(P[e1], P[e2], buf[i1], buf[i2], ls[i1],
                                    ls[i2])
    return buf, ls


@dataclass
class EdgeTensors:
    """The device-resident per-edge CLV tensors (the analog of the
    reference's precomputed partition). Site-last layout."""
    U: torch.Tensor        # [E, R, K, S] rest-of-tree CLV per edge
    V: torch.Tensor        # [E, R, K, S] subtree CLV per edge
    lsU: torch.Tensor      # [E, R, S] per-rate log scale of U
    lsV: torch.Tensor      # [E, R, S]
    lengths: torch.Tensor  # [E]


def build_edge_tensors(tree: Tree, eig: EigenModel, tip_clvs: np.ndarray,
                       dtype=torch.float64, device="cuda") -> EdgeTensors:
    edges, _ = build_reference_state(tree, eig, tip_clvs, dtype=dtype,
                                     device=device)
    return edges


def build_reference_state(tree: Tree, eig: EigenModel, tip_clvs: np.ndarray,
                          dtype=torch.float64, inv_logterm=None,
                          site_weights=None, device="cuda"):
    """EdgeTensors + reference-tree log-likelihood (P matrices -> CLV
    traversal -> edge gathers -> edge logl).

    ``site_weights``: [S] per-column multiplicities for the logl sum when
    ``tip_clvs`` holds pattern-COMPRESSED columns (the site-repeats analog,
    reference: src/io/file_io.cpp:216-220). None = every column weight 1.
    """
    dev = torch.device(device)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    ops = build_tree_ops(tree)
    U, V, lsU, lsV, logl = _reference_state(
        ops.ops, ops.u_idx, ops.v_idx, as_t(tip_clvs),
        as_t(tree.edge_lengths), as_t(eig.eigenvals), as_t(eig.A),
        as_t(eig.Ainv), as_t(eig.rates), as_t(eig.weights), as_t(eig.freqs),
        inv_logterm, None if site_weights is None else as_t(site_weights),
        n_clvs=ops.n_clvs, pinv=eig.pinv)
    edges = EdgeTensors(U=U, V=V, lsU=lsU, lsV=lsV,
                        lengths=as_t(tree.edge_lengths))
    return edges, float(logl)


def invariant_pattern_logls(tree: Tree, eig: EigenModel, dtype=torch.float64,
                            device="cuda"):
    """[K] log-likelihood of each all-invariant dummy column (state k at
    every tip), evaluated on the reference tree — the input to the
    ascertainment-bias correction (ops.likelihood.asc_bias_correction)."""
    dev = torch.device(device)
    K = eig.A.shape[-1]
    ops = build_tree_ops(tree)
    tip = np.broadcast_to(np.eye(K)[None], (tree.n_tips, K, K)).copy()
    P = pmatrices(eig, np.asarray(tree.edge_lengths), dtype=dtype, device=dev)
    buf, ls = _compute_clvs_core(
        ops.ops, P, torch.as_tensor(tip, dtype=dtype, device=dev),
        ops.n_clvs, len(eig.rates))
    u0, v0 = int(ops.u_idx[0]), int(ops.v_idx[0])
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    return likelihood.edge_logl_persite(
        buf[u0], ls[u0], buf[v0], ls[v0], P[0], as_t(eig.freqs),
        as_t(eig.weights))


def _reference_state(ops_arr, u_idx, v_idx, tip_clvs, edge_lengths,
                     eigenvals, A, Ainv, rates, weights, freqs,
                     inv_logterm, site_weights, n_clvs: int, pinv: float):
    """The whole init computation on tensors (the JAX package's
    ``_reference_state_jit``)."""
    t = edge_lengths[:, None] * rates / (1.0 - pinv)
    expd = torch.exp(t[..., None] * eigenvals)              # [E, R, K]
    if A.ndim == 3:   # matrix mixture: per-category eigen systems
        P = torch.einsum("rik,erk,rkj->erij", A, expd, Ainv)
    else:
        P = torch.einsum("ik,...k,kj->...ij", A, expd, Ainv)
    P = torch.clamp(P, min=0.0)
    buf, ls = _compute_clvs_core(ops_arr, P, tip_clvs, n_clvs,
                                 rates.shape[0])
    u_idx = torch.as_tensor(np.asarray(u_idx), dtype=torch.long,
                            device=buf.device)
    v_idx = torch.as_tensor(np.asarray(v_idx), dtype=torch.long,
                            device=buf.device)
    U, V, lsU, lsV = buf[u_idx], buf[v_idx], ls[u_idx], ls[v_idx]
    logl = likelihood.edge_loglikelihood(
        U[0], lsU[0], V[0], lsV[0], P[0], freqs, weights, pinv=pinv,
        inv_logterm=inv_logterm, site_mask=site_weights)
    return U, V, lsU, lsV, logl

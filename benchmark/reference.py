"""The plain reference: maximum-likelihood placement of reads on the
generated tree, in float64 with NumPy and PyTorch, from the generated data
alone.

Semantics (EPA-ng's, as its users see them in the jplace):

- A read placed on the edge above node n, at distance d from n (the end
  away from the root) with a pendant branch p, has the log-likelihood of
  the extended tree over the columns of its window [begin, begin + span):
  sum_s log sum_r w_r sum_k pi_k [P(r d) D_n]_k [P(r (L_n - d)) U_n]_k
  [P(r p) x_s]_k, with D_n the likelihood vector of the subtree below n,
  U_n that of the rest of the tree at n's parent, x_s the read's character.
- Premasking (on by default): a column drops out of every read where all
  the reads, or all the reference sequences, hold a gap there; a gap is
  any of "-?.NOX" in either alphabet (EPA-ng's gap set, so an all-N column
  of a protein alignment drops too).
- Preplacement (the dynamic heuristic) scores every edge at d = L/2 and
  p = -log(0.9), converts the scores to weights (a softmax) and keeps the
  best edges while the weight of those kept before stays under the
  threshold (0.99999).
- Each candidate edge gets its branch lengths at the likelihood's maximum
  over p in [1e-6, 100] and d in [0, L] (alternating golden-section
  searches, p on a log scale).
- The like-weight ratios (LWR) are a softmax over the candidates'
  maxima; the output keeps, by LWR descending, those above the support
  threshold (0.01), at least ``filter_min`` and at most ``filter_max``.

Likelihood vectors are rescaled per column as they are formed and the
logarithms of the scale factors carried beside them. ``rnd`` rounds the
operands of every contraction: the lower-precision control passes TF32's
rounding (10 explicit mantissa bits) and float32; the reference passes
none and float64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.datagen import Dataset
from benchmark.model import Model

PENDANT_MIN, PENDANT_MAX = 1e-6, 100.0
GAP_LETTERS = "-?.NOX"
PREPLACE_PENDANT = -math.log(0.9)
GOLDEN_ITERS = 40
ROUNDS = 5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round a float32 tensor to TF32 (10 explicit mantissa bits), nearest
    even."""
    i = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((i >> 13) & 1)
    return ((i + bias) & ~0x1FFF).view(torch.float32)


def _ident(x):
    return x


@dataclass
class Placement:
    node: int
    logl: float
    lwr: float
    distal: float    # from the node below the edge
    pendant: float


class Reference:
    """Likelihood vectors of every edge over the columns ``cols``, and the
    placement functions on them."""

    def __init__(self, ds: Dataset, model: Model, cols: np.ndarray,
                 device="cpu", dtype=torch.float64, rnd=None, masked=None):
        self.ds, self.model = ds, model
        self.masked = premasked(ds) if masked is None else masked
        self.dev, self.dtype = torch.device(device), dtype
        self.rnd = rnd or _ident
        self.cols = np.asarray(cols, dtype=np.int64)
        self.col_pos = np.full(ds.num_sites, -1, dtype=np.int64)
        self.col_pos[self.cols] = np.arange(len(self.cols))
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,
                                      device=self.dev)
        self.A, self.Ainv, self.lam = t(model.A), t(model.Ainv), t(model.lam)
        self.freqs, self.rates = t(model.freqs), t(model.rates)
        self.weights = t(model.weights)
        self.length = t(ds.length)
        self._vectors()

    # --- contractions -------------------------------------------------
    def _pmat(self, t: torch.Tensor) -> torch.Tensor:
        """[..., R, K, K] P(rate_r * t)."""
        e = torch.exp(self.lam * self.rates[:, None] * t[..., None, None])
        return (self.A * e[..., None, :]) @ self.Ainv

    def _apply(self, P: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """P [C, R, K, K] applied to vectors x [C, S, R, K]."""
        r = self.rnd
        return torch.einsum("crij,csrj->csri", r(P), r(x))

    @staticmethod
    def _rescale(v: torch.Tensor, ls: torch.Tensor):
        m = torch.amax(v, dim=(2, 3))
        m = torch.where(m > 0, m, torch.ones_like(m))
        return v / m[..., None, None], ls + torch.log(m)

    def _vectors(self):
        """Down vectors D_n (the subtree below n, at n) and up vectors U_n
        (the rest of the tree, at n's parent), each [N, S, R, K] with log
        scale factors [N, S]."""
        ds, R, K = self.ds, self.model.R, self.model.K
        N, S = len(ds.parent), len(self.cols)
        down = torch.zeros((N, S, R, K), dtype=self.dtype, device=self.dev)
        lsd = torch.zeros((N, S), dtype=self.dtype, device=self.dev)
        leaves = torch.as_tensor(ds.leaf_nodes, device=self.dev)
        st = torch.as_tensor(ds.states[ds.leaf_nodes][:, self.cols].astype(
            np.int64), device=self.dev)
        onehot = torch.nn.functional.one_hot(st, K).to(self.dtype)
        down[leaves] = onehot[:, :, None, :].expand(-1, -1, R, -1)

        kids = ds.children
        height = np.zeros(N, dtype=np.int64)
        order = _bfs(kids, ds.root)
        for level in reversed(order):
            for n in level:
                if kids[n]:
                    height[n] = 1 + max(height[c] for c in kids[n])
        P_edge = self._pmat(self.length)                    # [N, R, K, K]
        msg = torch.zeros_like(down)
        for h in range(1, int(height.max()) + 1):
            nodes = [n for n in range(N) if height[n] == h and n != ds.root]
            if not nodes:
                continue
            nodes_t = torch.as_tensor(nodes, device=self.dev)
            c0 = torch.as_tensor([kids[n][0] for n in nodes], device=self.dev)
            c1 = torch.as_tensor([kids[n][1] for n in nodes], device=self.dev)
            for c in (c0, c1):
                msg[c] = self._apply(P_edge[c], down[c])
            v, ls = self._rescale(msg[c0] * msg[c1], lsd[c0] + lsd[c1])
            down[nodes_t], lsd[nodes_t] = v, ls
        rk = torch.as_tensor(kids[ds.root], device=self.dev)
        msg[rk] = self._apply(P_edge[rk], down[rk])

        up = torch.zeros_like(down)
        lsu = torch.zeros_like(lsd)
        r = kids[ds.root]
        for i, c in enumerate(r):
            others = [o for o in r if o != c]
            v = msg[others[0]]
            ls = lsd[others[0]].clone()
            for o in others[1:]:
                v = v * msg[o]
                ls = ls + lsd[o]
            v, ls = self._rescale(v[None], ls[None])
            up[c], lsu[c] = v[0], ls[0]
        for level in order[2:]:
            nodes = torch.as_tensor(level, device=self.dev)
            par = torch.as_tensor(ds.parent[level], device=self.dev)
            sib = torch.as_tensor([kids[p][1] if kids[p][0] == n
                                   else kids[p][0]
                                   for n, p in zip(level, ds.parent[level])],
                                  device=self.dev)
            above = self._apply(P_edge[par], up[par])
            v, ls = self._rescale(above * msg[sib], lsu[par] + lsd[sib])
            up[nodes], lsu[nodes] = v, ls
        self.down, self.up, self.lsd, self.lsu = down, up, lsd, lsu

    # --- placement ----------------------------------------------------
    def _pairs(self, nodes: np.ndarray, reads: np.ndarray):
        """Eigenbasis vectors of a block of (edge, read) pairs over each
        read's window."""
        ds = self.ds
        L = int(ds.read_span[reads].max())
        j = np.arange(L)
        valid = j[None, :] < ds.read_span[reads, None]
        cols = np.where(valid, ds.read_begin[reads, None] + j[None, :],
                        ds.read_begin[reads, None])
        valid &= ~self.masked[cols]
        pos = self.col_pos[cols]
        if (pos < 0).any():
            raise ValueError("a read's window lies outside the reference's "
                             "columns")
        n_t = torch.as_tensor(nodes, device=self.dev)
        pos_t = torch.as_tensor(pos, device=self.dev)
        r = self.rnd
        AinvT = r(self.Ainv.T)
        D = r(self.down[n_t[:, None], pos_t]) @ AinvT       # [B, L, R, K]
        U = r(self.up[n_t[:, None], pos_t]) @ AinvT
        codes = torch.as_tensor(ds.read_codes[reads][:, :L].astype(np.int64),
                                device=self.dev)
        X = r(torch.nn.functional.one_hot(codes, self.model.K).to(
            self.dtype)) @ AinvT                            # [B, L, K]
        ls = (self.lsd[n_t[:, None], pos_t] + self.lsu[n_t[:, None], pos_t])
        mask = torch.as_tensor(valid, device=self.dev)
        return dict(D=D, U=U, X=X, ls=ls, mask=mask, Le=self.length[n_t])

    def _expo(self, t: torch.Tensor) -> torch.Tensor:
        """[B, R, K] exp(lam_k rate_r t_b)."""
        return torch.exp(self.lam * self.rates[:, None] * t[:, None, None])

    def _back(self, v: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        """A (e * v): vectors [B, L, R, K] from the eigenbasis."""
        r = self.rnd
        return r(v * e[:, None]) @ r(self.A.T)

    def _sum_sites(self, prod: torch.Tensor, pb) -> torch.Tensor:
        """log-likelihood of pairs from [B, L, R, K] products."""
        r = self.rnd
        site = r(prod) @ r(self.freqs)                      # [B, L, R]
        site = site @ self.weights                          # [B, L]
        ll = torch.log(torch.clamp(site, min=torch.finfo(site.dtype).tiny))
        return torch.where(pb["mask"], ll + pb["ls"],
                           torch.zeros_like(ll)).sum(dim=1)

    def logl(self, pb, pendant: torch.Tensor, distal: torch.Tensor):
        a = self._back(pb["D"], self._expo(distal))
        b = self._back(pb["U"], self._expo(pb["Le"] - distal))
        c = self._back(pb["X"][:, :, None, :].expand_as(pb["D"]),
                       self._expo(pendant))
        r = self.rnd
        return self._sum_sites(r(r(a) * r(b)) * r(c), pb)

    def optimise(self, pb):
        """Branch lengths at the likelihood's maximum: alternating
        golden-section searches from p = -log(0.9), d = L/2. Returns
        (logl, pendant, distal)."""
        B = pb["D"].shape[0]
        p = torch.full((B,), PREPLACE_PENDANT, dtype=self.dtype,
                       device=self.dev)
        d = pb["Le"] / 2
        lo_u = torch.full_like(p, math.log(PENDANT_MIN))
        hi_u = torch.full_like(p, math.log(PENDANT_MAX))
        r = self.rnd
        for _ in range(ROUNDS):
            ab = r(self._back(pb["D"], self._expo(d))) * r(
                self._back(pb["U"], self._expo(pb["Le"] - d)))
            X = pb["X"][:, :, None, :].expand_as(pb["D"])
            fp = lambda u: self._sum_sites(
                r(ab) * r(self._back(X, self._expo(torch.exp(u)))), pb)
            p = torch.exp(_golden(fp, lo_u, hi_u))
            c = r(self._back(X, self._expo(p)))
            fd = lambda dd: self._sum_sites(
                r(r(self._back(pb["D"], self._expo(dd)))
                  * r(self._back(pb["U"], self._expo(pb["Le"] - dd)))) * c,
                pb)
            d = _golden(fd, torch.zeros_like(d), pb["Le"].clone())
        return self.logl(pb, p, d), p, d

    def preplace(self, reads: np.ndarray) -> np.ndarray:
        """[len(reads), E] preplacement scores of every edge (columns in
        node order of ``edge_nodes``)."""
        nodes = self.edge_nodes
        out = np.zeros((len(reads), len(nodes)))
        for i, q in enumerate(reads):
            for b0 in range(0, len(nodes), 4096):
                nb = nodes[b0:b0 + 4096]
                pb = self._pairs(nb, np.full(len(nb), q))
                p = torch.full((len(nb),), PREPLACE_PENDANT, dtype=self.dtype,
                               device=self.dev)
                out[i, b0:b0 + len(nb)] = self.logl(
                    pb, p, pb["Le"] / 2).double().cpu().numpy()
        return out

    @property
    def edge_nodes(self) -> np.ndarray:
        return np.nonzero(self.ds.parent >= 0)[0]

    def solve_pairs(self, nodes: np.ndarray, reads: np.ndarray,
                    optimise: bool = True, block: int = 2048):
        """(logl, pendant, distal) numpy arrays over (edge, read) pairs, at
        the optimum or (``optimise=False``) at the starting lengths."""
        outs = [[], [], []]
        for b0 in range(0, len(nodes), block):
            pb = self._pairs(nodes[b0:b0 + block], reads[b0:b0 + block])
            if optimise:
                res = self.optimise(pb)
            else:
                p = torch.full((pb["D"].shape[0],), PREPLACE_PENDANT,
                               dtype=self.dtype, device=self.dev)
                res = (self.logl(pb, p, pb["Le"] / 2), p, pb["Le"] / 2)
            for o, v in zip(outs, res):
                o.append(v.double().cpu().numpy())
        return tuple(np.concatenate(o) for o in outs)

    def place(self, reads: np.ndarray, heuristic: bool, threshold: float,
              support: float, fmin: int, fmax: int, block: int = 2048,
              optimise: bool = True, drop_second: bool = False) -> dict:
        """Each read's placements, as the program's output would hold them:
        {read: (best logl among candidates, [Placement, ...])}.
        ``drop_second`` (a planted fault) leaves out each read's runner-up
        candidate: the second by preplacement score under the heuristic,
        else the second by log-likelihood."""
        edges = self.edge_nodes
        if heuristic:
            scores = self.preplace(reads)
            cand = [edges[dynamic_candidates(s, threshold)] for s in scores]
        else:
            cand = [edges] * len(reads)
        pn = np.concatenate(cand)
        pq = np.concatenate([np.full(len(c), q) for c, q in zip(cand, reads)])
        logl, pend, dist = self.solve_pairs(pn, pq, optimise, block)
        out, at = {}, 0
        for q, c in zip(reads, cand):
            k = np.arange(at, at + len(c))
            at += len(c)
            if drop_second and len(c) > 1:
                second = 1 if heuristic else np.argsort(-logl[k],
                                                        kind="stable")[1]
                c, k = np.delete(c, second), np.delete(k, second)
            out[int(q)] = (float(logl[k].max()), filtered(
                c, logl[k], pend[k], dist[k], support, fmin, fmax))
        return out

    def logl_at(self, nodes, reads, pendant, distal, block: int = 4096):
        """log-likelihood of pairs at given branch lengths."""
        out = []
        for b0 in range(0, len(nodes), block):
            sl = slice(b0, b0 + block)
            pb = self._pairs(nodes[sl], reads[sl])
            t = lambda x: torch.as_tensor(np.asarray(x[sl]), dtype=self.dtype,
                                          device=self.dev)
            out.append(self.logl(pb, t(pendant), t(distal)).double().cpu()
                       .numpy())
        return np.concatenate(out) if out else np.zeros(0)


def premasked(ds: Dataset) -> np.ndarray:
    """[S] bool: the columns premasking drops (all reads, or all reference
    sequences, gaps there)."""
    gap_state = np.asarray([c in GAP_LETTERS for c in ds.alphabet])
    S, L = ds.num_sites, ds.read_codes.shape[1]
    j = np.arange(L)
    held = (j[None, :] < ds.read_span[:, None]) & ~gap_state[ds.read_codes]
    q, jj = np.nonzero(held)
    read_has = np.zeros(S, dtype=bool)
    read_has[ds.read_begin[q] + jj] = True
    ref_has = (~gap_state[ds.states[ds.leaf_nodes]]).any(axis=0)
    return ~(read_has & ref_has)


def _bfs(children, root: int) -> list:
    levels, cur = [], [root]
    while cur:
        levels.append(cur)
        cur = [c for n in cur for c in children[n]]
    return levels


def _golden(f, lo: torch.Tensor, hi: torch.Tensor,
            iters: int = GOLDEN_ITERS) -> torch.Tensor:
    """Per-element maximiser of f over [lo, hi] (golden-section search;
    the best of the two interior points and both ends)."""
    g = (math.sqrt(5.0) - 1.0) / 2.0
    a, b = lo.clone(), hi.clone()
    c, d = b - g * (b - a), a + g * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        left = fc >= fd
        a, b = torch.where(left, a, c), torch.where(left, d, b)
        x = torch.where(left, b - g * (b - a), a + g * (b - a))
        fx = f(x)
        c, d = torch.where(left, x, d), torch.where(left, c, x)
        fc, fd = torch.where(left, fx, fd), torch.where(left, fc, fx)
    best, fbest = torch.where(fc >= fd, c, d), torch.maximum(fc, fd)
    for end in (lo, hi):
        fe = f(end)
        best = torch.where(fe > fbest, end, best)
        fbest = torch.maximum(fe, fbest)
    return best


def dynamic_candidates(scores: np.ndarray, threshold: float) -> np.ndarray:
    """Indices of the edges the dynamic heuristic keeps: best first while
    the weight of the edges kept before stays under ``threshold``."""
    order = np.argsort(-scores, kind="stable")
    s = scores[order]
    w = np.exp(s - s[0])
    w /= w.sum()
    before = np.cumsum(w) - w
    return order[before < threshold]


def lwr(logl: np.ndarray) -> np.ndarray:
    w = np.exp(logl - logl.max())
    return w / w.sum()


def filtered(nodes, logl, pend, dist, support: float, fmin: int,
             fmax: int) -> list:
    """LWR over the candidates, then the output filter: by LWR descending,
    those above ``support``, at least ``fmin``, at most ``fmax``."""
    w = lwr(logl)
    order = np.argsort(-w, kind="stable")
    keep = max(int((w > support).sum()), min(fmin, len(w)))
    if fmax:
        keep = min(keep, fmax)
    return [Placement(int(nodes[i]), float(logl[i]), float(w[i]),
                      float(dist[i]), float(pend[i])) for i in order[:keep]]

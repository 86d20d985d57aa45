"""The benchmark's data, made from ``--seed``: a random reference tree, a
reference alignment evolved down it under the configuration's model, and a
pool of distinct reads, each evolved from a point on a known ("true") edge
over its own alignment window only, all windows in one batch.

A vectorised counterpart of the evolved-read generator the port carries
for its tests: the tree grows by random attachment with branch lengths
Gamma(shape, scale) + floor; the root's states come from the stationary
frequencies; each site keeps one rate category down the whole tree; a read
attaches at a uniform fraction of its edge and grows out a pendant branch,
which is one evolution over the summed time (P(s) P(t) = P(s + t)).

Every seed gives the same multiset of read spans (evenly spread between the
configuration's bounds), in another order, so the work a pool asks for
does not swing with the seed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from benchmark.model import Model

# one independent random stream per part of the data
TREE, ALIGNMENT, READS, SAMPLE = 1, 2, 3, 4


def stream(seed: int, part: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), part])


@dataclass
class Dataset:
    alphabet: str
    parent: np.ndarray       # [N] node -> parent node (-1 at the root)
    children: list           # [N] lists of child nodes
    length: np.ndarray       # [N] length of the edge above each node
    root: int
    leaf_nodes: np.ndarray   # [n_taxa] node of taxon i (label f"T{i}")
    states: np.ndarray       # [N, S] uint8 states of every node
    site_cat: np.ndarray     # [S] rate category of each column
    read_node: np.ndarray    # [Q] true edge of each read (edge above node)
    read_begin: np.ndarray   # [Q] first column of each read's window
    read_span: np.ndarray    # [Q] window length
    read_codes: np.ndarray   # [Q, span_max] uint8 states (valid < span)

    @property
    def num_sites(self) -> int:
        return self.states.shape[1]

    @property
    def num_reads(self) -> int:
        return len(self.read_node)

    def read_name(self, i: int) -> str:
        """Names of one width, so the pool's records are rows of a matrix."""
        return f"q{i:0{len(str(self.num_reads - 1))}d}"

    def newick(self) -> str:
        taxon = self.taxon

        def rec(n: int) -> str:
            kids = self.children[n]
            if not kids:
                body = f"T{taxon[n]}"
            else:
                body = "(" + ",".join(rec(c) for c in kids) + ")"
            if n == self.root:
                return body
            return f"{body}:{self.length[n]:.6f}"
        return rec(self.root) + ";"

    @property
    def taxon(self) -> dict:
        return {int(n): i for i, n in enumerate(self.leaf_nodes)}


def random_tree(n_taxa: int, rng: np.random.Generator, shape: float,
                scale: float, floor: float):
    """Random attachment: each new taxon splits the edge above a uniformly
    drawn existing leaf. Returns (parent, children, length, root,
    leaf_nodes); lengths rounded to the 6 decimals the newick carries."""
    N = 2 * n_taxa - 2
    parent = np.full(N, -1, dtype=np.int64)
    length = np.zeros(N)
    children = [[] for _ in range(N)]
    draws = iter(np.round(rng.gamma(shape, scale, size=3 * n_taxa) + floor,
                          6))
    leaf_nodes = np.zeros(n_taxa, dtype=np.int64)
    root, nxt = 0, 1
    for i in range(3):
        parent[nxt], length[nxt] = root, next(draws)
        children[root].append(nxt)
        leaf_nodes[i] = nxt
        nxt += 1
    picks = rng.integers(0, np.arange(3, n_taxa))
    for i in range(3, n_taxa):
        target = int(leaf_nodes[picks[i - 3]])
        p = int(parent[target])
        mid, leaf = nxt, nxt + 1
        nxt += 2
        children[p][children[p].index(target)] = mid
        parent[mid], length[mid] = p, length[target]
        children[mid] = [target, leaf]
        parent[target], length[target] = mid, next(draws)
        parent[leaf], length[leaf] = mid, next(draws)
        leaf_nodes[i] = leaf
    return parent, children, length, root, leaf_nodes


def bfs_levels(children, root: int) -> list:
    levels, cur = [], [root]
    while cur:
        nxt = [c for n in cur for c in children[n]]
        if nxt:
            levels.append(np.asarray(nxt, dtype=np.int64))
        cur = nxt
    return levels


def _cumulative(P: np.ndarray) -> np.ndarray:
    """Row-wise cumulative distributions of probability rows [..., K]."""
    cum = np.cumsum(P, axis=-1)
    return (cum / cum[..., -1:]).astype(np.float32)


def _draw(cum_rows: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Categorical draws from cumulative rows [..., K] with uniforms
    [...]."""
    k = (u[..., None] > cum_rows).sum(axis=-1, dtype=np.uint8)
    return np.minimum(k, cum_rows.shape[-1] - 1)


def generate(cfg: dict, seed: int, pool: int | None = None) -> Dataset:
    """The configuration's tree, alignment and read pool for ``seed``."""
    model = Model(cfg)
    tcfg, rcfg = cfg["tree"], cfg["reads"]
    n_taxa, S, K = cfg["taxa"], cfg["sites"], model.K
    parent, children, length, root, leaf_nodes = random_tree(
        n_taxa, stream(seed, TREE), tcfg["branch_gamma_shape"],
        tcfg["branch_gamma_scale"], tcfg["branch_floor"])

    rng = stream(seed, ALIGNMENT)
    site_cat = rng.integers(0, model.R, size=S)
    states = np.zeros((len(parent), S), dtype=np.uint8)
    states[root] = _draw(_cumulative(model.freqs)[None, :],
                         rng.random(S, dtype=np.float32))
    for level in bfs_levels(children, root):
        cum = _cumulative(model.pmat(length[level]))        # [C, R, K, K]
        rows = cum[np.arange(len(level))[:, None], site_cat[None, :],
                   states[parent[level]]]                   # [C, S, K]
        states[level] = _draw(rows, rng.random((len(level), S),
                                               dtype=np.float32))

    # reads: a fixed multiset of spans in a seeded order
    Q = int(rcfg["pool"] if pool is None else pool)
    lo, hi = rcfg["span_min"], rcfg["span_max"]
    rng = stream(seed, READS)
    spans = (lo + (np.arange(Q) * (hi - lo + 1)) // Q)[rng.permutation(Q)]
    b_lo = rcfg.get("begin_min", 0)
    b_max = rcfg.get("begin_max")
    b_hi = S - spans if b_max is None else np.minimum(b_max, S - spans)
    begins = b_lo + np.floor(rng.random(Q) * (b_hi - b_lo + 1)).astype(
        np.int64)
    edges = np.nonzero(parent >= 0)[0]
    node = edges[rng.integers(0, len(edges), size=Q)]
    t = rng.random(Q) * length[node] + rcfg["pendant"]
    codes = np.zeros((Q, hi), dtype=np.uint8)
    j = np.arange(hi)
    for b0 in range(0, Q, 1024):
        sl = slice(b0, min(Q, b0 + 1024))
        B = sl.stop - sl.start
        cols = np.minimum(begins[sl, None] + j[None, :], S - 1)   # [B, L]
        cum = _cumulative(model.pmat(t[sl]))                       # [B,R,K,K]
        rows = cum[np.arange(B)[:, None], site_cat[cols],
                   states[node[sl, None], cols]]                   # [B, L, K]
        codes[sl] = _draw(rows, rng.random((B, hi), dtype=np.float32))
    codes[j[None, :] >= spans[:, None]] = 0
    return Dataset(alphabet=cfg["alphabet"], parent=parent,
                   children=children, length=length, root=root,
                   leaf_nodes=leaf_nodes, states=states, site_cat=site_cat,
                   read_node=node, read_begin=begins, read_span=spans,
                   read_codes=codes)


def _fasta_bytes(names: list, rows: np.ndarray) -> bytes:
    if len({len(n) for n in names}) == 1:
        # one record a row: ">name\n" + row + "\n"
        head = np.frombuffer("".join(f">{n}\n" for n in names).encode(),
                             dtype=np.uint8).reshape(len(names), -1)
        nl = np.full((len(rows), 1), ord("\n"), dtype=np.uint8)
        return np.concatenate([head, rows, nl], axis=1).tobytes()
    return b"".join(f">{n}\n".encode() + row.tobytes() + b"\n"
                    for n, row in zip(names, rows))


def write_files(ds: Dataset, outdir: str) -> dict:
    """tree.newick, reference.fasta and pool.fasta (full-width aligned
    reads, gaps outside each window) under ``outdir``; returns the paths."""
    lut = np.frombuffer(ds.alphabet.encode(), dtype=np.uint8)
    paths = {k: os.path.join(outdir, f) for k, f in
             (("tree", "tree.newick"), ("ref", "reference.fasta"),
              ("pool", "pool.fasta"))}
    with open(paths["tree"], "w") as f:
        f.write(ds.newick() + "\n")
    with open(paths["ref"], "wb") as f:
        f.write(_fasta_bytes([f"T{i}" for i in range(len(ds.leaf_nodes))],
                             lut[ds.states[ds.leaf_nodes]]))
    Q, S = ds.num_reads, ds.num_sites
    rows = np.full((Q, S), ord("-"), dtype=np.uint8)
    j = np.arange(ds.read_codes.shape[1])
    valid = j[None, :] < ds.read_span[:, None]
    qi, jj = np.nonzero(valid)
    rows[qi, ds.read_begin[qi] + jj] = lut[ds.read_codes[qi, jj]]
    with open(paths["pool"], "wb") as f:
        f.write(_fasta_bytes([ds.read_name(i) for i in range(Q)], rows))
    return paths

"""The plain reference against a brute-force likelihood of the extended
tree at a tiny size, its optimiser against a grid, and its heuristic,
filter and TF32 rounding against their definitions."""

import json
import math

import numpy as np
import pytest
import torch

from benchmark import datagen, reference
from benchmark.model import Model
from benchmark.tests.tiny import config_path


def _tiny(name, seed=3):
    with open(config_path(name)) as f:
        cfg = json.load(f)
    cfg.update(taxa=7, sites=40)
    cfg["reads"] = dict(cfg["reads"], pool=6, span_min=15, span_max=30,
                        begin_min=0, begin_max=None)
    return cfg, datagen.generate(cfg, seed)


def brute_logl(ds, model, node, read, pendant, distal):
    """The extended tree's log-likelihood over the read's window, by
    pruning towards the attachment point X on the edge above ``node``."""
    adj = {}
    for n, p in enumerate(ds.parent):
        if p >= 0 and n != node:
            adj.setdefault(n, []).append((p, ds.length[n]))
            adj.setdefault(p, []).append((n, ds.length[n]))
    X, Qn = "x", "q"
    par = int(ds.parent[node])
    for a, b, t in ((X, node, distal), (X, par, ds.length[node] - distal),
                    (X, Qn, pendant)):
        adj.setdefault(a, []).append((b, t))
        adj.setdefault(b, []).append((a, t))
    b0, s = ds.read_begin[read], ds.read_span[read]
    cols = np.arange(b0, b0 + s)
    K = model.K
    taxon = ds.taxon
    total = np.zeros(s)
    for r, (rate, w) in enumerate(zip(model.rates, model.weights)):
        def P(t):
            return (model.A * np.exp(model.lam * rate * t)) @ model.Ainv

        def vec(v, frm):
            if v == Qn:
                return np.eye(K)[ds.read_codes[read, :s]]
            if v != X and not ds.children[v] and v in taxon:
                return np.eye(K)[ds.states[v, cols]]
            out = np.ones((s, K))
            for nb, t in adj[v]:
                if nb != frm:
                    out *= vec(nb, v) @ P(t).T
            return out
        total += w * (vec(X, None) @ model.freqs)
    return float(np.log(total).sum())


@pytest.mark.parametrize("name", ["neotrop-gtr-g4", "lg-g4"])
def test_logl_matches_brute_force(name):
    cfg, ds = _tiny(name)
    model = Model(cfg)
    masked = np.zeros(ds.num_sites, dtype=bool)
    ref = reference.Reference(ds, model, np.arange(ds.num_sites),
                              masked=masked)
    rng = np.random.default_rng(0)
    nodes = ref.edge_nodes[rng.integers(0, len(ref.edge_nodes), 8)]
    reads = rng.integers(0, ds.num_reads, 8)
    pend = rng.uniform(0.001, 0.5, 8)
    dist = rng.uniform(0, 1, 8) * ds.length[nodes]
    got = ref.logl_at(nodes, reads, pend, dist)
    want = [brute_logl(ds, model, n, q, p, d)
            for n, q, p, d in zip(nodes, reads, pend, dist)]
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_optimiser_beats_a_grid():
    cfg, ds = _tiny("neotrop-gtr-g4")
    ref = reference.Reference(ds, Model(cfg), np.arange(ds.num_sites))
    nodes = ref.edge_nodes[:4]
    reads = np.array([0, 1, 2, 3])
    logl, pend, dist = ref.solve_pairs(nodes, reads)
    for i in range(4):
        ps = np.exp(np.linspace(math.log(1e-6), math.log(100), 60))
        ds_ = np.linspace(0, ds.length[nodes[i]], 60)
        P, D = np.meshgrid(ps, ds_)
        grid = ref.logl_at(np.full(P.size, nodes[i]), np.full(P.size,
                           reads[i]), P.ravel(), D.ravel())
        assert logl[i] >= grid.max() - 1e-6
        assert 1e-6 <= pend[i] <= 100 and 0 <= dist[i] <= ds.length[nodes[i]]


def test_premasking_drops_columns_all_gap_in_the_reads():
    cfg, ds = _tiny("lg-g4")
    m = reference.premasked(ds)
    covered = np.zeros(ds.num_sites, dtype=bool)
    n_state = ds.alphabet.index("N")
    for q in range(ds.num_reads):
        c = ds.read_codes[q, :ds.read_span[q]]
        covered[ds.read_begin[q] + np.nonzero(c != n_state)[0]] = True
    assert np.array_equal(m, ~covered)


def test_dynamic_candidates_and_filter():
    s = np.array([-10.0, -1.0, -1.0, -30.0, -2.0])
    keep = reference.dynamic_candidates(s, 0.99999)
    assert keep.tolist() == [1, 2, 4, 0]          # -30 is past the mass
    assert reference.dynamic_candidates(s, 0.3).tolist() == [1]
    logl = np.array([0.0, -1.0, -6.0, -0.5])
    out = reference.filtered(np.arange(4), logl, logl, logl, 0.01, 1, 2)
    assert [p.node for p in out] == [0, 3]
    assert abs(sum(p.lwr for p in reference.filtered(
        np.arange(4), logl, logl, logl, 0.0, 1, 7)) - 1) < 1e-12
    one = reference.filtered(np.arange(2), np.array([0.0, -50.0]),
                             np.zeros(2), np.zeros(2), 0.9999999, 1, 7)
    assert len(one) == 1


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -3.14159, 1e-30],
                     dtype=torch.float32)
    y = reference.tf32(x)
    assert ((y.view(torch.int32) & 0x1FFF) == 0).all()
    assert (((y - x).abs() / x.abs()) <= 2.0 ** -11).all()
    assert y[1] == 1.0 and y[2] == 1 + 2 ** -9

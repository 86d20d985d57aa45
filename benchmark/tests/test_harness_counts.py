"""The frozen count arithmetic against the port's own
(``ops/blo_kernel.py``), and the traced run's per-launch sums."""

import numpy as np
import pytest
import torch

from benchmark import counts
from benchmark.trace import NewtonRecorder
from epa_ng_tpu_torch.ops import blo_kernel

SHAPES = [dict(num_states=4, num_rates=4), dict(num_states=4, num_rates=16),
          dict(num_states=20, num_rates=4), dict(num_states=20, num_rates=1),
          dict(num_states=4, num_rates=4, has_pinv=True),
          dict(num_states=20, num_rates=16, has_pinv=True)]


def _pairs(n=257, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 500, n), rng.integers(0, 33, n),
            rng.integers(0, 300, n))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ops_match_the_port(shape):
    spans, sm, it = _pairs()
    assert counts.blo_op_count(spans, sm, it, **shape) == \
        blo_kernel.blo_op_count(spans, sm, it, **shape)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("counters", [False, True])
@pytest.mark.parametrize("mixture", [False, True])
def test_bytes_match_the_port(shape, counters, mixture):
    spans, _, _ = _pairs()
    kw = dict(shape, counters=counters, mixture=mixture)
    assert counts.blo_byte_count(spans, **kw) == \
        blo_kernel.blo_byte_count(spans, **kw)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_launch_bound_from_sums(shape):
    spans, sm, it = _pairs(seed=1)
    # every pair's windows on rows of its own: each cell read by one pair
    sums = (spans.sum(), (spans * sm).sum(), (spans * it).sum(), len(spans),
            spans.sum(), spans.sum())
    coef = counts.coefficients(shape["num_states"], shape["num_rates"],
                               shape.get("has_pinv", False), True)
    ops, nbytes, bound = counts.launch_bound(sums, coef)
    assert ops == pytest.approx(counts.blo_op_count(spans, sm, it, **shape),
                                rel=1e-12)
    assert nbytes == pytest.approx(counts.blo_byte_count(
        spans, counters=True, **shape), rel=1e-12)
    assert bound == max(ops / counts.PEAK_F32_FLOPS,
                        nbytes / counts.PEAK_HBM_BYTES)


def _fake_kernel(sm, it, calls):
    """A stand-in with the port's entry's parameter names."""
    def blo_newton(tables, tU, tV, tQ, e_ids, q_ids, begins, spans,
                   orig_len, skip, width, max_smoothings=32, counters=False,
                   invq=None, ls=None, omp=None, per_pair=False):
        calls.append(dict(width=width, max_smoothings=max_smoothings))
        outs = tuple(torch.zeros(len(spans)) for _ in range(5))
        return outs + ((torch.as_tensor(sm, dtype=torch.int32),
                        torch.as_tensor(it, dtype=torch.int32))
                       if counters else ())
    return blo_newton


def test_recorder_sums_live_pairs():
    """The recorder passes each call through as it came and sums what the
    kernel's counters say of its live pairs."""
    spans, sm, it = _pairs(n=128, seed=2)
    skip = np.zeros(128)
    skip[100:] = 1
    calls = []
    rec = NewtonRecorder(_fake_kernel(sm, it, calls), "cpu")
    rec.recording = True
    K, R = 4, 4
    tables = (torch.zeros(R * K), torch.zeros(R * K, K), torch.zeros(K, K),
              torch.zeros(K, K))
    ids = torch.arange(128, dtype=torch.int32)
    tU = torch.zeros(128, R * K, 512)
    zero = torch.zeros(128, dtype=torch.int32)
    rec(tables, tU, tU, tU, ids, ids, zero, torch.as_tensor(spans), zero,
        torch.as_tensor(skip), 512, max_smoothings=7, counters=True)
    tot = rec.totals()
    live = skip == 0
    assert tot["launches"] == 1 and tot["pairs"] == live.sum()
    assert tot["ops"] == pytest.approx(counts.blo_op_count(
        spans[live], sm[live], it[live], R, num_states=K), rel=1e-12)
    # rows of their own: the distinct cells are the windows themselves
    assert tot["bytes"] == pytest.approx(counts.blo_byte_count(
        spans[live], R, counters=True, num_states=K), rel=1e-12)
    assert calls[0] == dict(width=512, max_smoothings=7)


def test_recorder_counts_a_shared_window_once():
    """Pairs that read the same edge's and read's sites count them once."""
    spans = np.array([100, 100, 50, 10])
    begins = torch.tensor([0, 50, 0, 300], dtype=torch.int32)
    e_ids = torch.tensor([3, 3, 3, 1], dtype=torch.int32)
    q_ids = torch.tensor([0, 1, 0, 0], dtype=torch.int32)
    sm, it = np.ones(4), np.ones(4)
    rec = NewtonRecorder(_fake_kernel(sm, it, []), "cpu")
    rec.recording = True
    K, R = 4, 4
    tables = (torch.zeros(R * K), torch.zeros(R * K, K), torch.zeros(K, K),
              torch.zeros(K, K))
    tU, tQ = torch.zeros(5, R * K, 400), torch.zeros(2, K, 400)
    rec(tables, tU, tU, tQ, e_ids, q_ids, begins, torch.as_tensor(spans),
        torch.zeros(4), torch.zeros(4), 128, counters=True)
    coef = counts.coefficients(K, R)
    # edge 3: sites 0-149; edge 1: 300-309. read 0: 0-99 and 300-309;
    # read 1: 50-149
    want = (coef["edge_site_bytes"] * 160 + coef["query_site_bytes"] * 210
            + coef["pair_bytes"] * 4)
    assert rec.totals()["bytes"] == want


def test_recorder_refuses_an_entry_it_cannot_read():
    def kernel(tables, tU, *a, counters=False, **kw):
        return ()
    with pytest.raises(TypeError, match="no longer takes"):
        NewtonRecorder(kernel, "cpu")

"""The K = 4 Newton kernel's pairs in any order, and its layout past 8
rate categories, on the CPU.

The kernel's persistent CTAs take a launch's pairs in the order the
caller gives them and write each pair's results at the pair's own index.
These tests hold the plain version's independence of that order (what
lets the kernel take the pairs as they come: as drawn, reversed, sorted
by edge and begin, all on one edge), and the mirror of the runtime-R
instantiation's layout in ``kernel_geometry``: T's site count, its home
and the CTAs an SM. The kernel on the card is held to the same orders by
``tests/test_torch_cuda.py::test_kernel_pair_order_on_card``.
"""

import re

import numpy as np
import pytest
import torch

from epa_ng_tpu_torch.core.engine import PlacementEngine
from epa_ng_tpu_torch.models import Model
from epa_ng_tpu_torch.ops import blo_kernel as bk
from epa_ng_tpu_torch.utils.options import Options
from epa_ng_tpu_torch.utils.synth import synth_dataset

# one intra-op thread per test process (the suite runs in parallel workers)
torch.set_num_threads(1)


def _pairs(model, n_pairs, seed):
    tree, ref, qry = synth_dataset(n_taxa=16, sites=96, n_queries=16,
                                   seed=21)
    eng = PlacementEngine(tree, ref, Model.from_string(model),
                          Options(compute_dtype="f32"), device="cpu")
    ec = eng.encode_msa(qry)
    tQ, invq = eng._query_tensors_codes(ec.codes)
    rng = np.random.default_rng(seed)
    pq = rng.integers(0, len(ec), n_pairs)
    d = lambda x: torch.as_tensor(np.asarray(x, np.int32))
    return (eng, tQ, invq, d(rng.integers(0, eng.num_edges, n_pairs)),
            d(pq), d(ec.ranges[pq, 0]), d(ec.ranges[pq, 1]))


GTR = "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}"


@pytest.mark.parametrize("model", [GTR + "+G4{0.6}", GTR + "+G10{0.6}",
                                   GTR + "+I{0.25}+G16{0.6}"])
@pytest.mark.parametrize("edges", ["drawn", "one_edge"])
def test_plain_results_do_not_depend_on_pair_order(model, edges):
    """The plain version (the kernel's arithmetic and order) gives each
    pair the same outputs and counters, bit for bit, whether the pairs
    come as drawn, reversed or sorted by (edge, begin), and with every
    pair on one edge: a pair's result depends on no other pair, which is
    what lets the kernel take them in any order."""
    eng, tQ, invq, pe, pq, pb, sp = _pairs(model, 48, 7)
    if edges == "one_edge":
        pe = torch.full_like(pe, 5)
    blo = eng.blo
    tables = bk._kernel_scalars(eng.consts, torch.float32)
    kw = {}
    if eng.model.pinv > 0:
        kw = dict(invq=invq, ls=blo.ls, omp=bk._omp(eng.consts,
                                                    torch.float32))
    width = bk.kernel_width(sp.numpy())
    by_edge = torch.as_tensor(np.lexsort((pb.numpy(), pe.numpy())))
    runs = []
    for perm in (torch.arange(len(pe)), torch.arange(len(pe) - 1, -1, -1),
                 by_edge):
        got = bk.blo_newton(tables, blo.tU, blo.tV, tQ, pe[perm], pq[perm],
                            pb[perm], sp[perm], blo.lengths[pe[perm].long()],
                            torch.zeros(len(pe)), width, counters=True, **kw)
        inv = torch.argsort(perm)
        runs.append([t[inv] for t in got])
    assert torch.isfinite(runs[0][0]).all()
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("R,pinv,shared_sites", [
    (9, False, 1568), (9, True, 1280), (10, False, 1280), (11, True, 1088),
    (16, False, 832), (16, True, 832), (64, False, 192), (312, True, 32)])
def test_runtime_rate_layout_mirror(R, pinv, shared_sites):
    """The runtime-R instantiation (``RC = 0``) keeps ``TeamLayout``'s
    shared memory, which ``kernel_geometry`` mirrors: tables of 24 R + 32
    floats rounded up to 32, two exponential rows of RK floats (rounded up
    to 32) a warp, the warp slots, then T site-major at a stride of RK
    (+1 with +I) padded to 4 mod 8 floats, in shared memory up to
    ``shared_sites``; its rate loops add registers, not shared memory, so
    the cap stays 312."""
    rk = 4 * R
    assert bk._tab_bytes(4, R) == max(224, -(-(24 * R + 32) // 32) * 32) * 4
    assert bk._exp_bytes(4, R) == 4 * 2 * max(32, -(-rk // 32) * 32) * 4
    stride = -(-(rk + pinv) // 4) * 4
    stride += 4 if stride % 8 == 0 else 0
    assert bk._t_stride(4, rk, pinv) == stride
    fixed = bk._tab_bytes(4, R) + bk._exp_bytes(4, R) + bk._red_bytes(4)
    for width in (32, shared_sites):
        g = bk.kernel_geometry(4, R, width, has_pinv=pinv)
        assert g["t_shared"]
        assert g["shared_bytes"] == fixed + -(-stride * width // 32) * 32 * 4
    assert bk.max_shared_sites(rk, pinv) == shared_sites
    assert not bk.kernel_geometry(4, R, shared_sites + 32,
                                  has_pinv=pinv)["t_shared"]
    assert bk.MAX_RATES[(4, False)] == 312


@pytest.mark.parametrize("R,pinv,width", [
    (16, False, 200), (16, True, 200), (16, False, 1000), (9, True, 833),
    (4, False, 200), (312, True, 1)])
def test_dna_t_holds_the_width_rounded_to_32(R, pinv, width):
    """At K = 4 T holds the sumtable width rounded up to 32 sites
    (``dna_t_sites``), in shared memory and in each CTA's device-memory
    slice: the runtime-R loops give every lane of a warp work while its
    first lane is in the span, so they write T up to the span rounded up
    to 32, and the per-pair shape's width (``--memsave``'s slab, the
    alignment's sites) need not be a multiple of 32. The home rule does
    not move (``max_shared_sites`` is a multiple of 32); at K = 20 T keeps
    the width."""
    rk = 4 * R
    sites = -(-width // 32) * 32
    stride = bk._t_stride(4, rk, pinv)
    fixed = bk._tab_bytes(4, R) + bk._exp_bytes(4, R) + bk._red_bytes(4)
    g = bk.kernel_geometry(4, R, width, has_pinv=pinv)
    assert bk._t_sites(4, width) == sites
    assert g["t_shared"] == (width <= bk.max_shared_sites(rk, pinv))
    assert g["t_shared"] == bk.kernel_geometry(4, R, sites,
                                               has_pinv=pinv)["t_shared"]
    if g["t_shared"]:
        assert g["shared_bytes"] == fixed + -(-stride * sites // 32) * 32 * 4
    else:
        assert g["shared_bytes"] == fixed
    assert bk._t_sites(20, width) == width
    assert (bk.kernel_geometry(20, 4, 200)["shared_bytes"]
            == bk._team_fixed_bytes(20, 4, False) + 80 * 200 * 4)
    src = " ".join(open(bk._SRC).read().split())
    assert "inline int dna_t_sites(int width) { return round32(width); }" in src
    assert "dna_t_stride(rows) * dna_t_sites(width)" in src
    assert "c.ts() * dna_t_sites(width)" in src


def test_runtime_rates_hold_three_ctas_an_sm():
    """At R = 16 and the main path's width (256 sites) a CTA takes 73,472
    B of shared memory (tables 1,664, exponential rows 2,048, slots 128, T
    69,632), so an SM holds 3; the runtime-R instantiation's launch bound
    asks ptxas for 3 CTAs of 128 threads an SM in the shared home, at most
    168 registers a thread, which keeps all 3 (169 would leave 2)."""
    g = bk.kernel_geometry(4, 16, 256, regs=168)
    assert g["shared_bytes"] == 1664 + 2048 + 128 + 69632 == 73472
    assert g["ctas_per_sm"] == 3 and g["warps_per_sm"] == 12
    assert bk.kernel_geometry(4, 16, 256, regs=169)["ctas_per_sm"] == 2
    src = open(bk._SRC).read()
    bounds = re.search(r"__launch_bounds__\(DNA_TEAM,\s*([^)]*)\)", src)
    assert bounds and "RC == 0 ? 3" in " ".join(bounds.group(1).split())
    assert bk.SM_REGISTERS // (3 * bk.DNA_TEAM) // 8 * 8 == 168

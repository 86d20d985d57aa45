"""The K = 20 Newton kernel past 8 rate categories, on the CPU: a
thread-block cluster of ceil(R / 8) CTAs a pair (csrc/blo_newton.cu,
``CLUSTER``), each holding 8 of the rates. Here its geometry as
ops/blo_kernel.py mirrors it, the rate caps and the routing past them, and
the plain version at a 32-component matrix mixture against the JAX XLA
twin; tests/test_torch_cuda.py holds the kernel itself against its plain
version on the card.

The plain version adds the rates of a site in order r = 0..R-1 and the
sites of a 32-site tile as the cluster does (``team_site_sum``), the
order of the one-CTA build it replaced, so it is the one it was. Against
the JAX XLA twin (another form of the same optimum: a sumtable of the
normal-basis partials) logl agrees by tests/test_pallas.py's rule, as in
tests/test_torch_blo_kernel_aa.py::test_plain_matches_xla_twin_four_rates.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from epa_ng_tpu.models import aa_matrices
from epa_ng_tpu.ops import newton as jnewton
from epa_ng_tpu.ops import pallas_blo as jpb

from epa_ng_tpu_torch.core.engine import PlacementEngine, _check_device_model
from epa_ng_tpu_torch.models import Model as TModel
from epa_ng_tpu_torch.ops import blo_kernel as bk
from epa_ng_tpu_torch.utils.options import Options as TOptions
from test_torch_blo_kernel_aa import (T, _compare, _pairs, _per_pair_args,
                                      _state, mixture_components)

# one intra-op thread per test process: the suite runs in parallel
# workers, and a thread per core in each of them oversubscribes the
# CPU and slows the small tensor ops here by orders of magnitude
torch.set_num_threads(1)


@pytest.mark.parametrize("R,mix", [(9, False), (16, False), (16, True),
                                   (24, False), (32, True), (64, False),
                                   (64, True)])
def test_cluster_geometry(R, mix):
    """ceil(R / 8) CTAs a pair, each laid out for 8 rates (one a warp, a
    32-site tile): its slice's x_rk and wA rows, a mixture's A and piA rows
    or a single matrix's A and piA whole, 8 warps' exponential rows,
    reduction buffers of 512 units, and its 160 rows of T (161 with +I),
    so the LG+G16 windows (up to 256 sites) keep T in shared memory: up to
    288 sites for one matrix, with or without +I, and 256 for a mixture;
    within 227 KB a CTA, in device memory beyond."""
    g = bk.kernel_geometry(20, R, 256, mix)
    assert g["cluster"] == bk.cluster_ctas(20, R) == -(-R // 8)
    assert g["slice_rates"] == 8 and g["tile"] == 32
    assert g["threads"] == 256 and g["ctas_per_sm"] == 1
    tab = 160 + 160 * 20 + (2 * 160 * 20 if mix else 2 * 20 * 20)
    assert bk._tab_bytes(20, 8, mix) == -(-tab // 32) * 32 * 4
    fixed = bk._tab_bytes(20, 8, mix) + 8 * 2 * 32 * 4 + (6 * 512 + 32) * 4
    assert g["t_shared"] and g["shared_bytes"] == fixed + 160 * 256 * 4
    widest = bk.max_shared_sites(20 * R, False, 20, mix)
    assert widest == (256 if mix else 288)
    at = bk.kernel_geometry(20, R, widest, mix)
    assert at["t_shared"] and at["shared_bytes"] <= bk.SMEM_PER_BLOCK
    dev = bk.kernel_geometry(20, R, widest + 32, mix)
    assert not dev["t_shared"] and dev["shared_bytes"] == fixed
    if not mix:
        assert bk.max_shared_sites(20 * R, True, 20) == 288
        assert bk.kernel_geometry(20, R, 256, has_pinv=True)[
            "shared_bytes"] == fixed + 161 * 256 * 4
    # up to 8 rates one CTA a pair, as before
    assert bk.kernel_geometry(20, 8, 256, mix)["cluster"] == 1
    assert bk.kernel_geometry(4, R, 256)["cluster"] == 1


def test_rate_caps_and_the_twin_past_them():
    """The kernel takes up to 8 rates in each of the 8 CTAs of a portable
    cluster at K = 20 (64, one matrix or a mixture) and 312 at K = 4; one
    more is refused by name and takes the torch twin, as every such count
    lies past the JAX package's Pallas range (R K x 32 sites within its
    VMEM budget: 38 rates at K = 20, 192 at K = 4), where it runs its XLA
    twin."""
    assert bk.MAX_RATES == {(4, False): 312, (20, False): 64,
                            (20, True): 64}
    assert bk.MAX_RK_SITES == jpb.MAX_RK_SITES
    for (k, mix), cap in bk.MAX_RATES.items():
        pallas = max(r for r in range(1, cap + 1)
                     if jpb.max_kernel_sites(k * r) >= 32)
        assert pallas == {4: 192, 20: 38}[k] and pallas < cap
        assert not bk.twin_rates(k, cap, mix)
        assert bk.twin_rates(k, cap + 1, mix)
    eye = torch.eye(20, dtype=torch.float32)
    for mix in (False, True):
        for r, why in ((64, None), (65, "65 rate categories")):
            lead = (r,) if mix else ()
            c = SimpleNamespace(A=eye.expand(*lead, 20, 20),
                                rates=torch.ones(r))
            got = bk.blo_unsupported(c)
            assert got == why or why in got
            assert bk.twin_route(c) is (r > 64)


@pytest.mark.parametrize("states,rates,mixture,expect", [
    (20, 64, False, True), (20, 65, False, False), (20, 64, True, True),
    (20, 65, True, False), (20, 44, False, True), (20, 28, True, True),
    (4, 312, False, True), (4, 313, False, False)])
def test_engine_routing_past_the_cap(states, rates, mixture, expect):
    """On a cuda device in f32 the engine's Newton stage takes the kernel
    up to its cap and the torch twin past it, never "not yet ported"; the
    rule needs no card (it reads the engine's device, dtype, options and
    eigen constants)."""
    from epa_ng_tpu_torch.ops import newton as tnewton
    lead = (rates,) if mixture else ()
    consts = tnewton.EigConsts(
        eigenvals=torch.zeros(*lead, states),
        A=torch.eye(states).expand(*lead, states, states),
        Ainv=torch.eye(states).expand(*lead, states, states),
        freqs=torch.full((*lead, states), 1.0 / states),
        rates=torch.ones(rates), weights=torch.ones(rates) / rates,
        pinv=0.0)
    eng = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32,
                          consts=consts, options=TOptions())
    assert PlacementEngine._use_kernel(eng) is expect


def test_engine_past_the_cap_runs_the_twin_counted(monkeypatch):
    """LG+G65, one rate past the K = 20 cap: the card's check passes it,
    and an engine routed as on the card runs the torch twin, counted in its
    ``twin_launches``, never the kernel or its plain version (driven on a
    CPU engine of 6 taxa x 32 sites and 2 reads, the rule evaluated as on
    a cuda device in f32)."""
    from epa_ng_tpu_torch.utils.synth import AA, synth_dataset
    model = "LG+G65{0.8}"
    _check_device_model(torch.device("cuda"), TModel.from_string(model))
    tree, ref, qry = synth_dataset(n_taxa=6, sites=32, n_queries=2, seed=3,
                                   alphabet=AA)
    eng = PlacementEngine(tree, ref, TModel.from_string(model),
                          TOptions(compute_dtype="f32"), device="cpu")
    assert eng.consts.rates.shape[0] == 65
    on_card = SimpleNamespace(device=torch.device("cuda"),
                              dtype=torch.float32, consts=eng.consts,
                              options=eng.options)
    monkeypatch.setattr(eng, "_use_kernel",
                        lambda: PlacementEngine._use_kernel(on_card))

    def no_kernel(*a, **k):
        raise AssertionError("the kernel's wrapper ran past its cap")

    monkeypatch.setattr(bk, "blo_newton", no_kernel)
    got = eng.place_chunk(qry)
    assert len(got) == 2 and all(np.isfinite(p.logls).all() for p in got)
    assert eng.newton_work.totals()["twin_launches"] > 0


def test_plain_matches_xla_twin_32_components():
    """A 32-component LG-derived matrix mixture (+G32: a cluster of 4 CTAs
    a pair on the card), which the kernel now takes: 16 pairs on
    pre-sliced 64-site windows of random protein reads against the JAX XLA
    twin, at test_plain_matches_xla_twin_four_rates' tolerance."""
    name = "TESTCLUSTERMIX32"
    aa_matrices.MIXTURES[name] = (mixture_components(32), "gamma")
    try:
        st = _state(f"{name}+G32{{0.9}}", 12, 64, 8, seed=13)
    finally:
        aa_matrices.MIXTURES.pop(name, None)
    assert st["blo"].tU.shape[1] == 640 and st["tconsts"].A.ndim == 3
    assert bk.blo_unsupported(st["tconsts"]) is None
    assert not bk.twin_route(st["tconsts"])
    pe, pq, pb, sp = _pairs(st, 16, seed=6)
    args = _per_pair_args(st, pe, pq, pb, sp, False)
    ref = jnewton.blo_optimize_batch(st["eng"].consts, *args, sliding=True)
    got = bk.blo_optimize_batch_kernel(st["tconsts"], *[T(a) for a in args])
    _compare(ref, got, median_rel=1e-5)

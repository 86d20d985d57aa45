"""The CUDA Newton kernel on the card: against its plain version, and
refusing what it does not take instead of falling back. Skips without a
card. This file imports neither JAX nor the JAX package, so it also runs
where only the port is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The kernel and its plain version add in the same order (the team's), so
they agree bit for bit; where the plain version is not the reference
(the engine against the f64 CPU run), tolerances are
tests/test_torch_blo_kernel.py's (tests/test_pallas.py's): logl within
0.05 absolute, lengths by the 0.9 quantile over logl-sharp pairs.
"""

import numpy as np
import pytest
import torch

from epa_ng_tpu_torch.core.engine import PlacementEngine
from epa_ng_tpu_torch.models import Model
from epa_ng_tpu_torch.ops import blo_kernel as bk
from epa_ng_tpu_torch.ops import newton as tnewton
from epa_ng_tpu_torch.utils.options import Options
from epa_ng_tpu_torch.utils.synth import AA, evolved_dataset, synth_dataset

GTR = "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G4{0.6}"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _same_geometry(lib, g):
    """The library's launch geometry (the runtime's occupancy at the
    registers ptxas gave) is kernel_geometry's, on every key both give
    (the clusters the card holds at once are the runtime's alone)."""
    assert lib["active_clusters"] >= 1
    shared = [k for k in lib if k in g]
    assert {k: lib[k] for k in shared} == {k: g[k] for k in shared}


def _state(dev, n_pairs, seed, model=GTR, n_taxa=24, data_seed=9,
           with_invq=False, alphabet="ACGT", invariant=0.0):
    tree, ref, qry = synth_dataset(n_taxa=n_taxa, sites=200, n_queries=16,
                                   seed=data_seed, alphabet=alphabet)
    if invariant:
        from chip_smoke import lg_freqs, with_invariant_sites
        ref, qry, _ = with_invariant_sites(ref, qry, lg_freqs(), invariant,
                                           data_seed, alphabet)
    eng = PlacementEngine(tree, ref, Model.from_string(model),
                          Options(compute_dtype="f32"), device=dev)
    ec = eng.encode_msa(qry)
    tQ, invq = eng._query_tensors_codes(ec.codes)
    rng = np.random.default_rng(seed)
    pe = rng.integers(0, eng.num_edges, n_pairs).astype(np.int32)
    pq = rng.integers(0, len(ec), n_pairs).astype(np.int32)
    pb = ec.ranges[pq, 0].astype(np.int32)
    sp = ec.ranges[pq, 1].astype(np.int32)
    d = lambda x: torch.as_tensor(x, device=dev)
    out = (eng, tQ, d(pe), d(pq), d(pb), d(sp))
    return out + (invq,) if with_invq else out


def _assert_bitwise(got, ref):
    """Kernel outputs equal to the plain version's, bit for bit (the
    counters, if any, too)."""
    assert (got[0] - ref[0]).abs().max().item() == 0.0
    for k, r in zip(got[1:5], ref[1:5]):
        assert torch.equal(k, r)
    for k, r in zip(got[5:], ref[5:]):
        assert torch.equal(k.long(), r)


def _dna_width(home, pinv):
    """The sumtable width that puts a K = 4 launch (R = 4) in ``home``: T in
    shared memory at the main path's width (256) and at the widest window
    that keeps it there (max_shared_sites), or T in device memory (past
    it). The library's geometry (the runtime's occupancy at the registers
    ptxas gave) matches kernel_geometry's."""
    shared = bk.max_shared_sites(16, pinv)
    width = {"shared": 256, "widest": shared, "device": shared + 32}[home]
    lib = bk.blo_newton.team_geometry(4, 4, width, has_pinv=pinv,
                                      device_t=home == "device")
    g = bk.kernel_geometry(4, 4, width, has_pinv=pinv, regs=lib["regs"])
    assert g["t_shared"] == (home != "device")
    _same_geometry(lib, g)
    return width


@pytest.mark.requires_cuda
@pytest.mark.parametrize("home", ["shared", "widest", "device"])
def test_kernel_matches_plain_on_card(home):
    """The K = 4 kernel against its plain version, bit for bit, with the
    counters: the sumtable in shared memory (the main path's width 256,
    and the widest that fits, 2880) and in device memory (2912)."""
    dev = _card()
    width = _dna_width(home, False)
    eng, tQ, pe, pq, pb, sp = _state(dev, 512, seed=5)
    blo = eng.blo
    args = (blo.tU, blo.tV, tQ, pe, pq, pb, sp, blo.lengths[pe.long()],
            torch.zeros(len(pe), device=dev))
    tables = bk._kernel_scalars(eng.consts, torch.float32)
    before = bk.blo_newton.counts()
    got = bk.blo_newton(tables, *args, width, counters=True)
    torch.cuda.synchronize()
    after = bk.blo_newton.counts()
    assert after["k4_launches"] == before["k4_launches"] + 1
    assert after["launches"] == before["launches"] + 1
    _assert_bitwise(got, bk.blo_newton_plain(tables, *args, width,
                                             counters=True))


@pytest.mark.requires_cuda
def test_wrapper_raises_instead_of_falling_back():
    dev = _card()
    eng, tQ, pe, pq, pb, sp = _state(dev, 128, seed=6)
    blo = eng.blo
    c64 = tnewton.EigConsts(*[x.double() for x in eng.consts])
    before = bk.blo_newton.launches
    with pytest.raises(ValueError):
        # f64 stores on the card: the kernel refuses; nothing runs plain
        bk.blo_optimize_batch_kernel_blocked(
            c64, blo.tU.double(), blo.tV.double(), tQ.double(), pe, pq, pb,
            sp, blo.lengths.double()[pe.long()],
            torch.zeros(len(pe), device=dev, dtype=torch.float64), 256)
    cap = bk.MAX_RATES[(4, False)]
    with pytest.raises(ValueError):
        # one rate category past the cap: the kernel refuses it
        c_over = eng.consts._replace(
            rates=torch.ones(cap + 1, device=dev),
            weights=torch.ones(cap + 1, device=dev) / (cap + 1))
        tU_over = blo.tU.repeat(1, cap + 1, 1)[:, :4 * (cap + 1)]
        bk.blo_optimize_batch_kernel_blocked(
            c_over, tU_over, tU_over, tQ, pe, pq, pb, sp,
            blo.lengths[pe.long()], torch.zeros(len(pe), device=dev), 256)
    assert bk.blo_newton.launches == before
    # 9 rate categories run (the runtime-R instantiation)
    c9 = eng.consts._replace(rates=torch.ones(9, device=dev),
                             weights=torch.ones(9, device=dev) / 9)
    tU9 = torch.cat([blo.tU] * 3, dim=1)[:, :36].contiguous()
    bk.blo_optimize_batch_kernel_blocked(
        c9, tU9, tU9, tQ, pe, pq, pb, sp, blo.lengths[pe.long()],
        torch.zeros(len(pe), device=dev), 256)
    torch.cuda.synchronize()
    assert bk.blo_newton.counts()["past8_launches"] >= 1


@pytest.mark.requires_cuda
def test_engine_wide_windows_take_the_kernel(monkeypatch):
    """Reads spanning more sites than the shared-memory sumtable holds
    (3686 of 4096, past max_shared_sites(16) = 2880) go through the kernel
    on the card, in the fused step and in the exact path, never through
    the torch Newton.

    The kernel matches its plain version on the card on every (query,
    edge) pair, bit for bit, and the placements match the port's f64 CPU
    engine (best logl to 1e-5 relative, top edge up to ties) on at least
    90% of the queries (on this data one query's pendant Newton stalled in
    f32 at its lower bound before the guarded snap, ops.newton.cancelled,
    repaired the stall)."""
    dev = _card()
    tree, ref, qry, _ = evolved_dataset(n_taxa=24, sites=4096, n_queries=32,
                                        seed=4, model_str=GTR, read_frac=0.9)
    cpu = PlacementEngine(tree, ref, Model.from_string(GTR), Options(),
                          device="cpu")
    want = cpu.place_chunk(qry) + cpu._place_chunk_exact(
        cpu.encode_msa(qry), 0)

    def no_twin(*a, **k):
        raise AssertionError("the torch Newton ran on the card")

    monkeypatch.setattr(tnewton, "blo_optimize_batch", no_twin)
    eng = PlacementEngine(tree, ref, Model.from_string(GTR),
                          Options(compute_dtype="f32"), device=dev)
    ec = eng.encode_msa(qry)
    spans = ec.ranges[:, 1]
    assert int(spans.max()) > bk.max_shared_sites(16)
    before = bk.blo_newton.launches
    got = eng.place_chunk(qry)
    assert bk.blo_newton.launches > before
    before = bk.blo_newton.launches
    got += eng._place_chunk_exact(ec, 0)
    assert bk.blo_newton.launches > before

    # the kernel against its plain version on every pair of the chunk
    Q, E = len(ec), eng.num_edges
    pq = np.repeat(np.arange(Q), E).astype(np.int32)
    pe = np.tile(np.arange(E), Q).astype(np.int32)
    d = lambda x: torch.as_tensor(x, device=dev)
    tQ, _ = eng._query_tensors_codes(ec.codes)
    blo = eng.blo
    args = (blo.tU, blo.tV, tQ, d(pe), d(pq),
            d(ec.ranges[pq, 0].astype(np.int32)),
            d(spans[pq].astype(np.int32)), blo.lengths[d(pe).long()],
            torch.zeros(len(pe), device=dev))
    tables = bk._kernel_scalars(eng.consts, torch.float32)
    width = bk.kernel_width(spans)
    _assert_bitwise(bk.blo_newton(tables, *args, width),
                    bk.blo_newton_plain(tables, *args, width))

    assert [p.seq_id for p in got] == [p.seq_id for p in want]
    close, agree = [], []
    for x, y in zip(want, got):
        close.append(abs(y.logls[0] - x.logls[0]) <= 1e-5 * abs(x.logls[0]))
        ll = dict(zip(x.edge_nums.tolist(), x.logls.tolist()))
        agree.append(ll.get(int(y.edge_nums[0]), -np.inf)
                     >= x.logls[0] - 1e-5 * abs(x.logls[0]))
    assert np.mean(close) >= 0.9 and np.mean(agree) >= 0.9


PINV = GTR + "+I{0.25}"


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", ["blocked", "per_pair"])
@pytest.mark.parametrize("home", ["shared", "widest", "device"])
def test_pinv_kernel_matches_plain_on_card(shape, home):
    """The +I kernel (K2 blocked, K4 per-pair) against its plain version on
    the card, bit for bit, with the sumtable (and its pv row) in shared
    memory (width 256, and the widest that fits: max_shared_sites(16,
    True) = 2880) and in device memory (past it)."""
    dev = _card()
    width = _dna_width(home, True)
    eng, tQ, pe, pq, pb, sp, invq = _state(dev, 512, seed=8, model=PINV,
                                           n_taxa=16, data_seed=21,
                                           with_invq=True)
    assert torch.isfinite(invq).any()
    blo = eng.blo
    tables = bk._kernel_scalars(eng.consts, torch.float32)
    omp = bk._omp(eng.consts, torch.float32)
    before = bk.blo_newton.counts()
    if shape == "blocked":
        args = (blo.tU, blo.tV, tQ, pe, pq, pb, sp, blo.lengths[pe.long()],
                torch.zeros(len(pe), device=dev))
        pinv = dict(invq=invq, ls=blo.ls, omp=omp)
        got = bk.blo_newton(tables, *args, width, **pinv)
    else:
        # pre-sliced windows, zero-padded to the sumtable width
        S = blo.tU.shape[2]
        idx = (pb.long()[:, None]
               + torch.arange(width, device=dev)[None]).clamp(max=S - 1)
        on = torch.arange(width, device=dev)[None] < sp[:, None]
        rk = torch.arange(16, device=dev)[None, :, None]
        kq = torch.arange(4, device=dev)[None, :, None]
        e, q = pe.long()[:, None, None], pq.long()[:, None, None]
        z = on[:, None, :].float()
        tu = blo.tU[e, rk, idx[:, None]] * z
        tv = blo.tV[e, rk, idx[:, None]] * z
        tq = tQ[q, kq, idx[:, None]] * z
        lw = blo.ls[pe.long()[:, None], idx] * on
        iv = torch.where(on, invq[pq.long()[:, None], idx], -torch.inf)
        ids = torch.arange(len(pe), device=dev, dtype=torch.int32)
        begin0 = torch.zeros_like(pb)
        args = (tu, tv, tq, ids, ids, begin0, sp, blo.lengths[pe.long()],
                torch.zeros(len(pe), device=dev))
        pinv = dict(invq=iv, ls=lw, omp=omp)
        got = bk.blo_optimize_batch_kernel(
            eng.consts, tu, tv, tq, lw, on.float(), blo.lengths[pe.long()],
            iv, has_pinv=True)
        # the wrapper adds the window's log-scale sum to the kernel's logl
        shift = torch.sum(on.float() * lw, dim=1)
        got = (got[0], got[1], got[3])
    torch.cuda.synchronize()
    after = bk.blo_newton.counts()
    assert after["launches"] == before["launches"] + 1
    assert after["pinv_launches"] == before["pinv_launches"] + 1
    ref = bk.blo_newton_plain(tables, *args, width, **pinv)
    if shape == "per_pair":
        ref = (ref[0] + shift,) + ref[1:]
    _assert_bitwise(got, ref)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("model", [GTR, PINV])
def test_kernel_counters_match_plain_on_card(model):
    """K5: the kernel's per-pair executed smoothings and Newton iterations
    equal its plain version's on at least 99% of the pairs (a pair whose
    f32 trajectory parts takes another count), and turning the counters on
    changes no result."""
    dev = _card()
    eng, tQ, pe, pq, pb, sp, invq = _state(dev, 512, seed=9, model=model,
                                           n_taxa=16, data_seed=21,
                                           with_invq=True)
    blo = eng.blo
    args = (blo.tU, blo.tV, tQ, pe, pq, pb, sp, blo.lengths[pe.long()],
            torch.zeros(len(pe), device=dev))
    tables = bk._kernel_scalars(eng.consts, torch.float32)
    pinv = {}
    if model == PINV:
        pinv = dict(invq=invq, ls=blo.ls,
                    omp=bk._omp(eng.consts, torch.float32))
    before = bk.blo_newton.counts()
    got = bk.blo_newton(tables, *args, 256, counters=True, **pinv)
    plain_run = bk.blo_newton(tables, *args, 256, **pinv)
    torch.cuda.synchronize()
    after = bk.blo_newton.counts()
    assert after["counted_launches"] == before["counted_launches"] + 1
    for a, b in zip(got[:5], plain_run):
        assert torch.equal(a, b)
    ref = bk.blo_newton_plain(tables, *args, 256, counters=True, **pinv)
    for k, r in zip(got[5:], ref[5:]):
        same = (k.long() == r).float().mean().item()
        assert same >= 0.99, same


def _dna_args(dev, n_pairs, seed, model):
    eng, tQ, pe, pq, pb, sp, invq = _state(dev, n_pairs, seed=seed,
                                           model=model, n_taxa=16,
                                           data_seed=21, with_invq=True)
    blo = eng.blo
    args = (blo.tU, blo.tV, tQ, pe, pq, pb, sp, blo.lengths[pe.long()],
            torch.zeros(len(pe), device=dev))
    kw = {}
    if model == PINV:
        kw = dict(invq=invq, ls=blo.ls,
                  omp=bk._omp(eng.consts, torch.float32))
    return bk._kernel_scalars(eng.consts, torch.float32), args, kw


@pytest.mark.requires_cuda
@pytest.mark.parametrize("model", [GTR, PINV])
def test_dna_kernel_dead_slots(model):
    """The fused step hands the kernel mostly dead slots (skip): with 90%
    of 4096 slots dead, more slots than the persistent grid has CTAs, so
    each CTA walks live and dead slots in turn, the live pairs' outputs
    and counters are the same as with none dead, every dead slot reports
    the frozen state (logl 0, the default pendant, half the edge each
    side, done, no work), and both runs are the plain version's, bit for
    bit."""
    dev = _card()
    tables, args, kw = _dna_args(dev, 4096, 12, model)
    geo = bk.blo_newton.team_geometry(4, 4, 256, has_pinv=model == PINV)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert len(args[3]) > 2 * sms * geo["ctas_per_sm"]
    full = bk.blo_newton(tables, *args, 256, counters=True, **kw)
    rng = np.random.default_rng(3)
    dead = torch.as_tensor(rng.random(len(args[3])) < 0.9, device=dev)
    some_args = args[:-1] + (dead.float(),)
    some = bk.blo_newton(tables, *some_args, 256, counters=True, **kw)
    torch.cuda.synchronize()
    live = ~dead
    assert 300 < int(live.sum()) < 500
    for a, b in zip(full, some):
        assert torch.equal(a[live], b[live])
    orig = args[7][dead]
    assert (some[0][dead] == 0).all()
    assert (some[1][dead] == np.float32(tnewton.DEFAULT_PENDANT)).all()
    assert torch.equal(some[2][dead], orig * 0.5)
    assert torch.equal(some[3][dead], orig * 0.5)
    assert (some[4][dead] == 1).all()
    assert (some[5][dead] == 0).all() and (some[6][dead] == 0).all()
    _assert_bitwise(full, bk.blo_newton_plain(tables, *args, 256,
                                              counters=True, **kw))
    _assert_bitwise(some, bk.blo_newton_plain(tables, *some_args, 256,
                                              counters=True, **kw))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n_pairs", [1, 100])
@pytest.mark.parametrize("model", [GTR, PINV])
def test_dna_kernel_few_pairs(model, n_pairs):
    """Fewer pairs than the persistent grid holds (the launcher caps the
    grid at P), down to one: each pair's outputs and counters are the
    plain version's, bit for bit, and those of the same pair in a launch
    of 512."""
    dev = _card()
    tables, args, kw = _dna_args(dev, 512, 5, model)
    full = bk.blo_newton(tables, *args, 256, counters=True, **kw)
    few = args[:3] + tuple(t[:n_pairs] for t in args[3:])
    got = bk.blo_newton(tables, *few, 256, counters=True, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, full):
        assert torch.equal(a, b[:n_pairs])
    _assert_bitwise(got, bk.blo_newton_plain(tables, *few, 256,
                                             counters=True, **kw))


@pytest.mark.requires_cuda
def test_engine_pinv_takes_the_kernel(monkeypatch):
    """A +I model on data with invariant columns places through the +I
    kernel on the card (fused step and exact path), never through the
    torch Newton or the kernel's plain version, and agrees with the port's f64 CPU engine: best logl
    within 1e-5 relative and the top edge up to ties on >= 90% of
    queries (the wide-window test's rule)."""
    from chip_smoke import with_invariant_sites
    dev = _card()
    tree, ref, qry, _ = evolved_dataset(n_taxa=32, sites=300, n_queries=64,
                                        seed=6, model_str=GTR)
    ref, qry, _ = with_invariant_sites(ref, qry, (0.27, 0.23, 0.24, 0.26),
                                       0.2, seed=2)
    model = "GTR+IC+G4"
    cpu = PlacementEngine(tree, ref, Model.from_string(model), Options(),
                          device="cpu")
    want = cpu.place_chunk(qry) + cpu._place_chunk_exact(
        cpu.encode_msa(qry), 0)

    def no_twin(*a, **k):
        raise AssertionError("the torch Newton ran on the card")

    monkeypatch.setattr(tnewton, "blo_optimize_batch", no_twin)
    monkeypatch.setattr(bk, "blo_newton_plain", no_twin)
    eng = PlacementEngine(tree, ref, Model.from_string(model),
                          Options(compute_dtype="f32"), device=dev)
    assert eng.model.pinv > 0.2
    before = bk.blo_newton.counts()
    got = eng.place_chunk(qry)
    got += eng._place_chunk_exact(eng.encode_msa(qry), 0)
    after = bk.blo_newton.counts()
    assert after["pinv_launches"] > before["pinv_launches"]
    assert after["launches"] - before["launches"] == (
        after["pinv_launches"] - before["pinv_launches"])
    work = eng.newton_work.totals()
    assert work["newton_pairs"] > 0
    assert work["newton_iters"] >= 2 * work["newton_smoothings"]

    assert [p.seq_id for p in got] == [p.seq_id for p in want]
    close, agree = [], []
    for x, y in zip(want, got):
        close.append(abs(y.logls[0] - x.logls[0]) <= 1e-5 * abs(x.logls[0]))
        ll = dict(zip(x.edge_nums.tolist(), x.logls.tolist()))
        agree.append(ll.get(int(y.edge_nums[0]), -np.inf)
                     >= x.logls[0] - 1e-5 * abs(x.logls[0]))
    assert np.mean(close) >= 0.9 and np.mean(agree) >= 0.9


AA_CASES = {"lg": "LG+G4{0.8}", "lg_pinv": "LG+I{0.25}+G4{0.8}",
            "mixture": "SMOKEMIX4M+G4{0.9}"}


@pytest.fixture()
def mixture_registered():
    """chip_smoke's four-component LG-derived mixture in the port's table."""
    from chip_smoke import MIXTURE, register_mixture
    from epa_ng_tpu_torch.models import aa_matrices
    register_mixture()
    yield
    aa_matrices.MIXTURES.pop(MIXTURE, None)


def _aa_state(dev, case, n_pairs=512, seed=10):
    pinv = case == "lg_pinv"
    eng, tQ, pe, pq, pb, sp, invq = _state(
        dev, n_pairs, seed=seed, model=AA_CASES[case], n_taxa=16,
        data_seed=21, with_invq=True, alphabet=AA,
        invariant=0.2 if pinv else 0.0)
    blo = eng.blo
    args = (blo.tU, blo.tV, tQ, pe, pq, pb, sp, blo.lengths[pe.long()],
            torch.zeros(len(pe), device=dev))
    tables = bk._kernel_scalars(eng.consts, torch.float32)
    kw = {}
    if pinv:
        assert torch.isfinite(invq).any()
        kw = dict(invq=invq, ls=blo.ls,
                  omp=bk._omp(eng.consts, torch.float32))
    return eng, tQ, args, tables, kw


def _aa_width(home, case):
    """The sumtable width that puts a K = 20 launch in ``home``: T in
    shared memory at the main paths' width (128) and at the widest window
    that keeps it there (max_shared_sites), or T in device memory (past
    it). The library's geometry (the runtime's occupancy at the registers
    ptxas gave) matches kernel_geometry's."""
    pinv, mix = case == "lg_pinv", case == "mixture"
    shared = bk.max_shared_sites(80, pinv, 20, mix)
    width = {"shared": 128, "widest": shared, "device": shared + 64}[home]
    lib = bk.blo_newton.team_geometry(20, 4, width, mix, pinv,
                                      device_t=home == "device")
    g = bk.kernel_geometry(20, 4, width, mix, pinv, regs=lib["regs"])
    assert g["t_shared"] == (home != "device")
    _same_geometry(lib, g)
    return width


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", sorted(AA_CASES))
@pytest.mark.parametrize("home", ["shared", "widest", "device"])
def test_aa_kernel_matches_plain_on_card(case, home, mixture_registered):
    """The K = 20 instantiations (protein with one matrix, with +I on data
    with 20% invariant columns, and a matrix mixture: per-rate tables, a
    per-category tip) against their plain version on the card, bit for
    bit (the plain version adds in the team's order), with the counters,
    with T in shared memory (at the main paths' width and at the widest
    window that fits) and in device memory; each launch counts in its
    family."""
    dev = _card()
    pinv, mix = case == "lg_pinv", case == "mixture"
    eng, tQ, args, tables, kw = _aa_state(dev, case)
    RK = eng.blo.tU.shape[1]
    assert RK == 80 and tQ.shape[1] == (80 if mix else 20)
    width = _aa_width(home, case)
    family = "mixture_launches" if mix else "k20_launches"
    before = bk.blo_newton.counts()
    got = bk.blo_newton(tables, *args, width, counters=True, **kw)
    torch.cuda.synchronize()
    after = bk.blo_newton.counts()
    assert after[family] == before[family] + 1
    assert after["pinv_launches"] == before["pinv_launches"] + pinv
    _assert_bitwise(got, bk.blo_newton_plain(tables, *args, width,
                                             counters=True, **kw))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["lg", "mixture"])
def test_aa_kernel_dead_slots(case, mixture_registered):
    """The fused step hands the kernel mostly dead slots (skip): with 90%
    of them dead, the live pairs' outputs and counters are the same as
    with none dead, and every dead slot reports the frozen state
    (logl 0, the default pendant, half the edge each side, done, no
    work)."""
    dev = _card()
    eng, tQ, args, tables, kw = _aa_state(dev, case, n_pairs=1024, seed=12)
    full = bk.blo_newton(tables, *args, 128, counters=True, **kw)
    rng = np.random.default_rng(3)
    dead = torch.as_tensor(rng.random(len(args[3])) < 0.9, device=dev)
    some = bk.blo_newton(tables, *args[:-1], dead.float(), 128,
                         counters=True, **kw)
    torch.cuda.synchronize()
    live = ~dead
    assert 50 < int(live.sum()) < 200
    for a, b in zip(full, some):
        assert torch.equal(a[live], b[live])
    orig = args[7][dead]
    assert (some[0][dead] == 0).all()
    assert (some[1][dead] == np.float32(tnewton.DEFAULT_PENDANT)).all()
    assert torch.equal(some[2][dead], orig * 0.5)
    assert torch.equal(some[3][dead], orig * 0.5)
    assert (some[4][dead] == 1).all()
    assert (some[5][dead] == 0).all() and (some[6][dead] == 0).all()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["lg", "mixture"])
def test_engine_aa_takes_the_kernel(monkeypatch, case, mixture_registered):
    """Protein (evolved LG+G4 reads) and mixture (random reads) place
    through the K = 20 kernel on the card, fused step and exact path, never
    through the torch Newton or the kernel's plain version; the placements
    agree with the port's f64 CPU engine (best logl within 1e-5 relative,
    top edge up to ties) on >= 90% of queries."""
    dev = _card()
    model = AA_CASES[case]
    if case == "lg":
        tree, ref, qry, _ = evolved_dataset(n_taxa=24, sites=200,
                                            n_queries=32, seed=3,
                                            model_str=model, alphabet=AA)
    else:
        tree, ref, qry = synth_dataset(n_taxa=16, sites=160, n_queries=24,
                                       seed=13, alphabet=AA)
    cpu = PlacementEngine(tree, ref, Model.from_string(model), Options(),
                          device="cpu")
    want = cpu.place_chunk(qry) + cpu._place_chunk_exact(
        cpu.encode_msa(qry), 0)

    def no_twin(*a, **k):
        raise AssertionError("the torch Newton ran on the card")

    monkeypatch.setattr(tnewton, "blo_optimize_batch", no_twin)
    monkeypatch.setattr(bk, "blo_newton_plain", no_twin)
    eng = PlacementEngine(tree, ref, Model.from_string(model),
                          Options(compute_dtype="f32"), device=dev)
    family = "mixture_launches" if case == "mixture" else "k20_launches"
    before = bk.blo_newton.counts()
    got = eng.place_chunk(qry)
    got += eng._place_chunk_exact(eng.encode_msa(qry), 0)
    after = bk.blo_newton.counts()
    assert after[family] > before[family]
    assert (after["launches"] - before["launches"]
            == after[family] - before[family])

    assert [p.seq_id for p in got] == [p.seq_id for p in want]
    close, agree = [], []
    for x, y in zip(want, got):
        close.append(abs(y.logls[0] - x.logls[0]) <= 1e-5 * abs(x.logls[0]))
        ll = dict(zip(x.edge_nums.tolist(), x.logls.tolist()))
        agree.append(ll.get(int(y.edge_nums[0]), -np.inf)
                     >= x.logls[0] - 1e-5 * abs(x.logls[0]))
    assert np.mean(close) >= 0.9 and np.mean(agree) >= 0.9


def _register_mixture9():
    """Nine LG-derived components (chip_smoke.register_mixture's recipe),
    gamma-coupled, as SMOKEMIX9 in the port's mixture table."""
    from epa_ng_tpu_torch.models import aa_matrices
    rng = np.random.RandomState(11)
    lg_r, lg_f = aa_matrices.MATRICES["LG"]
    comps = []
    for _ in range(9):
        r = lg_r * np.exp(0.35 * rng.randn(190))
        f = lg_f * np.exp(0.35 * rng.randn(20))
        comps.append((r, f / f.sum()))
    aa_matrices.MIXTURES["SMOKEMIX9"] = (comps, "gamma")


RATE_CASES = {"dna": ("GTR{{1.1/2.9/0.8/1.2/3.4/1}}+FU{{0.27/0.23/0.24/"
                      "0.26}}+G{R}{{0.6}}"),
              "pinv": ("GTR{{1.1/2.9/0.8/1.2/3.4/1}}+FU{{0.27/0.23/0.24/"
                       "0.26}}+I{{0.25}}+G{R}{{0.6}}"),
              "lg": "LG+G{R}{{0.8}}", "mixture": "SMOKEMIX9+G{R}{{0.9}}"}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case,R", [("dna", 9), ("dna", 10), ("dna", 11),
                                    ("dna", 16), ("pinv", 9), ("pinv", 10),
                                    ("pinv", 11), ("pinv", 16), ("lg", 9),
                                    ("lg", 16), ("mixture", 9)])
@pytest.mark.parametrize("home", ["shared", "widest", "device"])
def test_kernel_past_eight_rates_matches_plain_on_card(case, R, home):
    """Past 8 rate categories (the K = 4 runtime-R instantiation, without
    and with +I, at every remainder of its 4-rate chunks; the K = 20
    cluster of two CTAs a pair, one matrix and a nine-component mixture)
    the kernel matches its plain version on the card bit for bit, with
    the counters, with T in shared memory (at 128 sites and at the widest
    window that fits) and in device memory; each launch counts past 8
    rates, and the library's geometry matches kernel_geometry's."""
    _past_eight_rates(case, R, home, 128)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case,R,width", [("dna", 64, 128),
                                          ("pinv", 64, 128),
                                          ("dna", 312, 32),
                                          ("pinv", 312, 32)])
@pytest.mark.parametrize("home", ["shared", "widest", "device"])
def test_kernel_wide_rates_matches_plain_on_card(case, R, width, home):
    """The K = 4 runtime-R instantiation at 64 rates (128 sites) and at
    its cap, 312 (32 sites: the widest window whose T fits beside its
    tables), bit for bit with its plain version and the counters in every
    sumtable home."""
    assert R <= bk.MAX_RATES[(4, False)]
    _past_eight_rates(case, R, home, width)


def _past_eight_rates(case, R, home, shared_width):
    """One launch past 8 rates in ``home`` against the plain version (T in
    shared memory at ``shared_width`` sites, at the widest window that
    keeps it there, or in device memory past that)."""
    dev = _card()
    pinv, mix = case == "pinv", case == "mixture"
    K = 4 if case in ("dna", "pinv") else 20
    if mix:
        _register_mixture9()
    try:
        eng, tQ, pe, pq, pb, sp, invq = _state(
            dev, 256, seed=R, model=RATE_CASES[case].format(R=R),
            n_taxa=16, data_seed=21, with_invq=True,
            alphabet="ACGT" if K == 4 else AA)
    finally:
        if mix:
            from epa_ng_tpu_torch.models import aa_matrices
            aa_matrices.MIXTURES.pop("SMOKEMIX9", None)
    blo = eng.blo
    assert blo.tU.shape[1] == K * R
    shared = bk.max_shared_sites(K * R, pinv, K, mix)
    width = {"shared": shared_width, "widest": shared,
             "device": shared + 32}[home]
    lib = bk.blo_newton.team_geometry(K, R, width, mix, pinv,
                                      device_t=home == "device")
    g = bk.kernel_geometry(K, R, width, mix, pinv, regs=lib["regs"])
    assert g["t_shared"] == (home != "device")
    _same_geometry(lib, g)
    args = (blo.tU, blo.tV, tQ, pe, pq, pb, sp, blo.lengths[pe.long()],
            torch.zeros(len(pe), device=dev))
    tables = bk._kernel_scalars(eng.consts, torch.float32)
    kw = (dict(invq=invq, ls=blo.ls, omp=bk._omp(eng.consts, torch.float32))
          if pinv else {})
    before = bk.blo_newton.counts()
    got = bk.blo_newton(tables, *args, width, counters=True, **kw)
    torch.cuda.synchronize()
    after = bk.blo_newton.counts()
    assert after["past8_launches"] == before["past8_launches"] + 1
    _assert_bitwise(got, bk.blo_newton_plain(tables, *args, width,
                                             counters=True, **kw))


# the per-pair shape's cases: (model, K, R): the K = 4 runtime-R
# instantiation without and with +I, K = 20 with one matrix, the
# four-component mixture and the K = 20 cluster (two CTAs a pair)
PER_PAIR_CASES = {"dna": (RATE_CASES["dna"].format(R=16), 4, 16),
                  "pinv": (RATE_CASES["pinv"].format(R=16), 4, 16),
                  "lg": (AA_CASES["lg"], 20, 4),
                  "mixture": (AA_CASES["mixture"], 20, 4),
                  "lg16": ("LG+G16{0.8}", 20, 16)}


def _per_pair_state(dev, case, n_pairs, seed):
    """(engine, tQ, pair edges, pair queries, invq) for a PER_PAIR_CASES
    case (the mixture registered by the caller)."""
    model, K, _ = PER_PAIR_CASES[case]
    eng, tQ, pe, pq, _, _, invq = _state(
        dev, n_pairs, seed=seed, model=model, n_taxa=16, data_seed=21,
        with_invq=True, alphabet="ACGT" if K == 4 else AA)
    return eng, tQ, pe, pq, invq


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", sorted(PER_PAIR_CASES))
@pytest.mark.parametrize("width", [200, 1000])
def test_kernel_per_pair_width_off_32_on_card(case, width,
                                              mixture_registered):
    """The per-pair shape (K3, +I K4) with a window width that is not a
    multiple of 32, as ``--memsave`` and the mesh's exact redo give it
    (the slab width, or the alignment's sites): 200 (T in shared memory)
    and 1000 (T in device memory, one slice per CTA), with spans up to the
    width; at K = 4, R = 16 (the runtime-R loops write T up to the span
    rounded up to 32 sites, which the layout holds), at K = 20 with one
    matrix and a mixture, and on the K = 20 cluster at R = 16 (T holds
    exactly the width there). Bit for bit with the plain version and the
    counters, and the library's geometry is kernel_geometry's."""
    dev = _card()
    pinv = case == "pinv"
    _, K, R = PER_PAIR_CASES[case]
    mix = case == "mixture"
    eng, tQ, pe, pq, invq = _per_pair_state(dev, case, 192, width)
    blo = eng.blo
    S = blo.tU.shape[2]
    home = ("shared" if width <= bk.max_shared_sites(K * R, pinv, K, mix)
            else "device")
    assert home == ("shared" if width == 200 else "device")
    lib = bk.blo_newton.team_geometry(K, R, width, mix, pinv,
                                      device_t=home == "device")
    g = bk.kernel_geometry(K, R, width, mix, pinv, regs=lib["regs"])
    assert g["t_shared"] == (home == "shared")
    _same_geometry(lib, g)
    # each pair's window: the store's sites repeated out to the width, its
    # span past the width's last multiple of 32 for most pairs
    cols = torch.arange(width, device=dev) % S
    e, q = pe.long(), pq.long()
    tu, tv = blo.tU[e][:, :, cols], blo.tV[e][:, :, cols]
    tq = tQ[q][:, :, cols]
    rng = np.random.default_rng(width)
    sp = torch.as_tensor(rng.integers(width - 31, width + 1, len(pe)),
                         dtype=torch.int32, device=dev)
    sp[::8] = torch.as_tensor(rng.integers(1, width + 1, len(sp[::8])),
                              dtype=torch.int32, device=dev)
    assert (sp > width // 32 * 32).sum() >= len(sp) // 8
    ids = torch.arange(len(pe), dtype=torch.int32, device=dev)
    args = (tu, tv, tq, ids, ids, torch.zeros_like(ids), sp,
            blo.lengths[e], torch.zeros(len(pe), device=dev))
    tables = bk._kernel_scalars(eng.consts, torch.float32)
    kw = (dict(invq=invq[q][:, cols], ls=blo.ls[e][:, cols],
               omp=bk._omp(eng.consts, torch.float32)) if pinv else {})
    before = bk.blo_newton.counts()
    got = bk.blo_newton(tables, *args, width, counters=True, per_pair=True,
                        **kw)
    torch.cuda.synchronize()
    after = bk.blo_newton.counts()
    assert after["per_pair_launches"] == before["per_pair_launches"] + 1
    assert (after["cluster_launches"] - before["cluster_launches"]
            == (case == "lg16"))
    _assert_bitwise(got, bk.blo_newton_plain(tables, *args, width,
                                             counters=True, **kw))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n_pairs", [1, 47])
@pytest.mark.parametrize("case", ["lg", "mixture", "lg16"])
def test_per_pair_few_pairs_on_card(case, n_pairs, mixture_registered):
    """The per-pair shape at K = 20 (one matrix, the mixture) and on the
    cluster with fewer pairs than a wave, as ``--memsave``'s last slab and
    its redo pass give them (1 and 47 pairs; a slab at RK = 320 and
    width 256 holds 48): each pair's outputs and counters are the plain
    version's, bit for bit, and those of the same pair in a launch of
    256 (pre-gathered 128-site windows)."""
    dev = _card()
    eng, tQ, pe, pq, _ = _per_pair_state(dev, case, 256, 17)
    blo = eng.blo
    W = 128
    cols = torch.arange(W, device=dev)
    e, q = pe.long(), pq.long()
    rng = np.random.default_rng(n_pairs)
    sp = torch.as_tensor(rng.integers(1, W + 1, len(pe)), dtype=torch.int32,
                         device=dev)
    ids = torch.arange(len(pe), dtype=torch.int32, device=dev)
    args = (blo.tU[e][:, :, cols].contiguous(),
            blo.tV[e][:, :, cols].contiguous(),
            tQ[q][:, :, cols].contiguous(), ids, ids, torch.zeros_like(ids),
            sp, blo.lengths[e], torch.zeros(len(pe), device=dev))
    tables = bk._kernel_scalars(eng.consts, torch.float32)
    full = bk.blo_newton(tables, *args, W, counters=True, per_pair=True)
    few = tuple(t[:n_pairs] for t in args[:3]) + tuple(
        t[:n_pairs] for t in args[3:])
    got = bk.blo_newton(tables, *few, W, counters=True, per_pair=True)
    torch.cuda.synchronize()
    for a, b in zip(got, full):
        assert torch.equal(a, b[:n_pairs])
    _assert_bitwise(got, bk.blo_newton_plain(tables, *few, W,
                                             counters=True))


ORDER_MODELS = {"g4": GTR, "g16": RATE_CASES["dna"].format(R=16),
                "pinv_g16": RATE_CASES["pinv"].format(R=16)}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("model", sorted(ORDER_MODELS))
@pytest.mark.parametrize("edges", ["drawn", "one_edge"])
def test_kernel_pair_order_on_card(model, edges):
    """The K = 4 kernel's persistent CTAs take a launch's pairs as they
    come and write each pair's results at its own index: the same pairs
    given as drawn, reversed and shuffled (and all moved onto one edge,
    where every pair in flight shares its rows) give the same outputs and
    counters, bit for bit, pair by pair, and the plain version's."""
    dev = _card()
    pinv = model == "pinv_g16"
    eng, tQ, pe, pq, pb, sp, invq = _state(
        dev, 512, seed=8, model=ORDER_MODELS[model], n_taxa=16,
        data_seed=21, with_invq=True)
    blo = eng.blo
    if edges == "one_edge":
        pe = torch.full_like(pe, 3)
    tables = bk._kernel_scalars(eng.consts, torch.float32)
    kw = (dict(invq=invq, ls=blo.ls, omp=bk._omp(eng.consts, torch.float32))
          if pinv else {})
    rng = np.random.default_rng(4)
    perms = {"drawn": torch.arange(len(pe), device=dev),
             "reversed": torch.arange(len(pe) - 1, -1, -1, device=dev),
             "shuffled": torch.as_tensor(rng.permutation(len(pe)),
                                         device=dev)}
    runs = {}
    for name, perm in perms.items():
        args = (blo.tU, blo.tV, tQ, pe[perm], pq[perm], pb[perm], sp[perm],
                blo.lengths[pe[perm].long()],
                torch.zeros(len(pe), device=dev))
        got = bk.blo_newton(tables, *args, 256, counters=True, **kw)
        inv = torch.argsort(perm)
        runs[name] = [t[inv] for t in got]
        if name == "drawn":
            want = bk.blo_newton_plain(tables, *args, 256, counters=True,
                                       **kw)
    torch.cuda.synchronize()
    _assert_bitwise(runs["drawn"], want)
    for name in ("reversed", "shuffled"):
        for a, b in zip(runs[name], runs["drawn"]):
            assert torch.equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("heuristic", ["fixed", "baseball"])
def test_exact_budgets_g16_on_card(tmp_path, monkeypatch, heuristic):
    """``-G 0.1`` (fixed) and ``--baseball-heur`` give the fused step
    exact budgets (ceil(G E) and 40 candidates a query, not halved) and
    so launch the K = 4 runtime-R instantiation at top-k up to E: GTR+G16
    on a small reference (64 taxa x 200 sites, 256 reads, seed 5) places
    through the kernel alone, never the torch twin, and agrees with the
    port's f64 CPU run (top edge up to ties on >= 99% of reads, best logl
    within 1e-5 relative): ``chip_smoke.exact_budgets``, phase 5's."""
    import chip_smoke as cs
    _card()
    monkeypatch.setattr(cs, "OUT", str(tmp_path))
    res = cs.exact_budgets(
        "cuda", {heuristic: cs.EXACT_BUDGETS[heuristic]})[heuristic]
    assert res["launches"] > 0 and res["twin_launches"] == 0
    assert res["agreement"]["top_edge_up_to_ties"] >= 0.99


@pytest.mark.requires_cuda
def test_engine_g16_takes_the_kernel(monkeypatch):
    """GTR+G16 places through the K = 4 runtime-R instantiation on the
    card, fused step and exact path, never through the torch Newton; the
    placements agree with the port's f64 CPU engine (best logl within 1e-5
    relative, top edge up to ties) on >= 90% of queries."""
    dev = _card()
    model = GTR.replace("+G4{0.6}", "+G16{0.6}")
    tree, ref, qry, _ = evolved_dataset(n_taxa=24, sites=200, n_queries=32,
                                        seed=3, model_str=GTR)
    cpu = PlacementEngine(tree, ref, Model.from_string(model), Options(),
                          device="cpu")
    want = cpu.place_chunk(qry) + cpu._place_chunk_exact(
        cpu.encode_msa(qry), 0)
    twin = []
    monkeypatch.setattr(tnewton, "blo_optimize_batch",
                        lambda *a, **k: twin.append(1))
    eng = PlacementEngine(tree, ref, Model.from_string(model),
                          Options(compute_dtype="f32"), device=dev)
    before = bk.blo_newton.counts()
    got = eng.place_chunk(qry)
    got += eng._place_chunk_exact(eng.encode_msa(qry), 0)
    after = bk.blo_newton.counts()
    assert not twin
    launched = after["launches"] - before["launches"]
    assert launched > 0
    assert after["past8_launches"] - before["past8_launches"] == launched
    assert after["k4_launches"] - before["k4_launches"] == launched
    assert [p.seq_id for p in got] == [p.seq_id for p in want]
    close, agree = [], []
    for x, y in zip(want, got):
        close.append(abs(y.logls[0] - x.logls[0]) <= 1e-5 * abs(x.logls[0]))
        ll = dict(zip(x.edge_nums.tolist(), x.logls.tolist()))
        agree.append(ll.get(int(y.edge_nums[0]), -np.inf)
                     >= x.logls[0] - 1e-5 * abs(x.logls[0]))
    assert np.mean(close) >= 0.9 and np.mean(agree) >= 0.9


CLUSTER_CASES = {"lg9": ("LG+G9{0.8}", None), "lg16": ("LG+G16{0.8}", None),
                 "lg24": ("LG+G24{0.8}", None),
                 "lg_pinv16": ("LG+I{0.2}+G16{0.8}", None),
                 "mix16": ("SMOKEMIX16M+G16{0.9}", 16),
                 "mix32": ("SMOKEMIX32M+G32{0.9}", 32)}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
@pytest.mark.parametrize("home", ["shared", "device"])
@pytest.mark.parametrize("shape", ["blocked", "per_pair"])
def test_cluster_matches_plain_on_card(case, home, shape):
    """The K = 20 cluster (ceil(R / 8) CTAs a pair, 8 rates each) against
    its plain version on the card, bit for bit with the counters: LG at
    R = 9, 16 and 24 (clusters of 2, 2 and 3), LG+I{0.2}+G16 on data with
    20% invariant columns, and 16- and 32-component mixtures; with T in
    shared memory (128 sites) and in device memory (past the widest
    shared window), through the blocked call shape (windows of the full
    stores) and the per-pair one (pre-gathered 64-site windows); each
    launch counts as a cluster launch past 8 rates, and the library's
    geometry is kernel_geometry's."""
    from chip_smoke import register_mixture
    from epa_ng_tpu_torch.models import aa_matrices
    dev = _card()
    model, comps = CLUSTER_CASES[case]
    pinv, mix = case == "lg_pinv16", comps is not None
    if mix:
        register_mixture(comps, model.split("+")[0])
    try:
        eng, tQ, pe, pq, pb, sp, invq = _state(
            dev, 256, seed=len(case), model=model, n_taxa=16, data_seed=21,
            with_invq=True, alphabet=AA, invariant=0.2 if pinv else 0.0)
    finally:
        if mix:
            aa_matrices.MIXTURES.pop(model.split("+")[0], None)
    blo = eng.blo
    R = blo.tU.shape[1] // 20
    shared = bk.max_shared_sites(20 * R, pinv, 20, mix)
    width = {"shared": 128, "device": shared + 32}[home]
    lib = bk.blo_newton.team_geometry(20, R, width, mix, pinv,
                                      device_t=home == "device")
    g = bk.kernel_geometry(20, R, width, mix, pinv, regs=lib["regs"])
    assert g["t_shared"] == (home == "shared")
    assert lib["cluster"] == -(-R // 8) > 1
    _same_geometry(lib, g)
    tables = bk._kernel_scalars(eng.consts, torch.float32)
    omp = bk._omp(eng.consts, torch.float32)
    orig, skip = blo.lengths[pe.long()], torch.zeros(len(pe), device=dev)
    if shape == "blocked":
        args = (blo.tU, blo.tV, tQ, pe, pq, pb, sp, orig, skip)
        kw = dict(invq=invq, ls=blo.ls, omp=omp) if pinv else {}
    else:
        S, W = blo.tU.shape[2], 64
        wb = torch.clamp(pb, max=S - W).long()
        idx = wb[:, None] + torch.arange(W, device=dev)[None]
        rows = lambda n: torch.arange(n, device=dev)[None, :, None]
        e, q = pe.long()[:, None, None], pq.long()[:, None, None]
        cut = lambda t, i, n: t[i, rows(n), idx[:, None, :]].contiguous()
        ids = torch.arange(len(pe), dtype=torch.int32, device=dev)
        args = (cut(blo.tU, e, 20 * R), cut(blo.tV, e, 20 * R),
                cut(tQ, q, tQ.shape[1]), ids, ids,
                (pb - wb).to(torch.int32), torch.clamp(sp, max=W), orig,
                skip)
        kw = (dict(invq=invq[pq.long()[:, None], idx].contiguous(),
                   ls=blo.ls[pe.long()[:, None], idx].contiguous(), omp=omp)
              if pinv else {})
    before = bk.blo_newton.counts()
    got = bk.blo_newton(tables, *args, width, counters=True,
                        per_pair=shape == "per_pair", **kw)
    torch.cuda.synchronize()
    after = bk.blo_newton.counts()
    for key in ("cluster_launches", "past8_launches", f"{shape}_launches",
                "mixture_launches" if mix else "k20_launches"):
        assert after[key] == before[key] + 1, key
    _assert_bitwise(got, bk.blo_newton_plain(tables, *args, width,
                                             counters=True, **kw))


@pytest.mark.requires_cuda
def test_refused_cluster_launch_raises(monkeypatch):
    """A cluster launch the runtime refuses (its code, here
    cudaErrorLaunchOutOfResources from a stand-in for the library's
    launch) raises, counts nothing and runs nothing in its place; and the
    library itself refuses a cluster of more than 8 CTAs (72 rates)."""
    dev = _card()
    eng, tQ, pe, pq, pb, sp = _state(dev, 128, seed=7, model="LG+G16{0.8}",
                                     n_taxa=16, data_seed=21, alphabet=AA)
    blo = eng.blo
    real = bk.blo_newton.build(False, "team")

    class Refusing:
        blo_newton_team_geometry = real.blo_newton_team_geometry
        blo_newton_error_string = real.blo_newton_error_string

        @staticmethod
        def blo_newton_launch(*args):
            return 701               # cudaErrorLaunchOutOfResources

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(bk.blo_newton, "build",
                        lambda has_pinv=False, part="dna": Refusing)
    monkeypatch.setattr(bk, "blo_newton_plain", no_plain)
    before = bk.blo_newton.counts()
    with pytest.raises(RuntimeError, match="launch failed.*701"):
        bk.blo_newton(bk._kernel_scalars(eng.consts, torch.float32),
                      blo.tU, blo.tV, tQ, pe, pq, pb, sp,
                      blo.lengths[pe.long()], torch.zeros(len(pe),
                                                          device=dev), 128)
    assert bk.blo_newton.counts() == before
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="unsupported"):
        bk.blo_newton.team_geometry(20, 72, 128)


@pytest.mark.requires_cuda
def test_engine_mixture32_and_past_the_cap_on_card(monkeypatch):
    """A 32-component matrix mixture places on the card through the
    cluster (4 CTAs a pair), fused step and exact path, never the torch
    Newton; LG+G65, one rate past the kernel's cap, takes the torch twin
    on the card (as the JAX package's XLA twin), counted, never the
    kernel. Placements agree with the port's f64 CPU engine (best logl
    within 1e-5 relative, top edge up to ties) on >= 90% of queries."""
    from chip_smoke import register_mixture
    from epa_ng_tpu_torch.models import aa_matrices
    dev = _card()
    register_mixture(32, "SMOKEMIX32M")
    try:
        for model, kernel, (taxa, sites, reads) in (
                ("SMOKEMIX32M+G32{0.9}", True, (10, 64, 8)),
                ("LG+G65{0.8}", False, (8, 48, 6))):
            tree, ref, qry = synth_dataset(n_taxa=taxa, sites=sites,
                                           n_queries=reads, seed=13,
                                           alphabet=AA)
            cpu = PlacementEngine(tree, ref, Model.from_string(model),
                                  Options(), device="cpu")
            want = cpu.place_chunk(qry) + cpu._place_chunk_exact(
                cpu.encode_msa(qry), 0)
            eng = PlacementEngine(tree, ref, Model.from_string(model),
                                  Options(compute_dtype="f32"), device=dev)
            before = bk.blo_newton.counts()
            got = eng.place_chunk(qry)
            got += eng._place_chunk_exact(eng.encode_msa(qry), 0)
            after = bk.blo_newton.counts()
            twin = eng.newton_work.totals()["twin_launches"]
            launched = after["cluster_launches"] - before["cluster_launches"]
            if kernel:
                assert launched > 0 and twin == 0
                assert (after["launches"] - before["launches"] == launched
                        == after["mixture_launches"]
                        - before["mixture_launches"])
            else:
                assert after["launches"] == before["launches"] and twin > 0
            close, agree = _agreement(want, got)
            assert close >= 0.9 and agree >= 0.9
    finally:
        aa_matrices.MIXTURES.pop("SMOKEMIX32M", None)


def _agreement(want, got):
    """Shares of queries whose best logl agrees to 1e-5 relative, and
    whose top edge the reference scores within 1e-5 of its best."""
    assert [p.seq_id for p in got] == [p.seq_id for p in want]
    close, agree = [], []
    for x, y in zip(want, got):
        close.append(abs(y.logls[0] - x.logls[0]) <= 1e-5 * abs(x.logls[0]))
        ll = dict(zip(x.edge_nums.tolist(), x.logls.tolist()))
        agree.append(ll.get(int(y.edge_nums[0]), -np.inf)
                     >= x.logls[0] - 1e-5 * abs(x.logls[0]))
    return np.mean(close), np.mean(agree)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("model,alphabet,sliding", [
    ("BIN+G2{1.2}", "01", True),
    ("GTGTR4{1.5/2.5/0.8/1.2/3.0/1.0}+FE+G4{0.8}", "ACGTMRSWYK", True),
    (GTR, "ACGT", False)])
def test_engine_twin_paths_on_card(model, alphabet, sliding):
    """Binary (K = 2) and genotype (K = 10) models and ``--raxml-blo`` run
    the torch twin on the card (the JAX package runs them on its XLA twin),
    fused step and exact path, never the kernel, and count its calls; the
    placements agree with the port's f64 CPU engine (best logl within 1e-5
    relative, top edge up to ties) on >= 90% of queries."""
    dev = _card()
    tree, ref, qry, _ = evolved_dataset(
        n_taxa=24, sites=200, n_queries=32, seed=3,
        model_str=model if alphabet != "ACGT" else None, alphabet=alphabet)
    cpu = PlacementEngine(tree, ref, Model.from_string(model),
                          Options(sliding_blo=sliding), device="cpu")
    want = cpu.place_chunk(qry) + cpu._place_chunk_exact(
        cpu.encode_msa(qry), 0)
    eng = PlacementEngine(tree, ref, Model.from_string(model),
                          Options(compute_dtype="f32", sliding_blo=sliding),
                          device=dev)
    before = bk.blo_newton.counts()
    got = eng.place_chunk(qry)
    got += eng._place_chunk_exact(eng.encode_msa(qry), 0)
    assert bk.blo_newton.counts()["launches"] == before["launches"]
    assert eng.newton_work.totals()["twin_launches"] > 0
    close, agree = _agreement(want, got)
    assert close >= 0.9 and agree >= 0.9


@pytest.mark.requires_cuda
def test_binary_store_places_on_card(tmp_path):
    """A store dumped on the card (f32) and loaded there with ``-b``
    places through the kernel like the direct run on the card."""
    import json
    import os

    from epa_ng_tpu_torch.cli import main
    from epa_ng_tpu_torch.utils.synth import write_fasta
    _card()
    tree, ref, qry, _ = evolved_dataset(n_taxa=24, sites=200, n_queries=32,
                                        seed=3, model_str=GTR)
    tpath = str(tmp_path / "tree.nwk")
    with open(tpath, "w") as f:
        f.write(tree.plain_newick() + "\n")
    rpath, qpath = str(tmp_path / "ref.fasta"), str(tmp_path / "q.fasta")
    write_fasta(ref, rpath)
    write_fasta(qry, qpath)
    common = ["--redo", "--device", "cuda"]
    assert main(["--tree", tpath, "--ref-msa", rpath, "--model", GTR,
                 "--dump-binary", "--outdir", str(tmp_path / "d")]
                + common) == 0
    store = str(tmp_path / "d" / "epa_binary_file.npz")
    before = bk.blo_newton.counts()["launches"]
    assert main(["-b", store, "--query", qpath, "--outdir",
                 str(tmp_path / "b")] + common) == 0
    assert bk.blo_newton.counts()["launches"] > before
    assert main(["--tree", tpath, "--ref-msa", rpath, "--model", GTR,
                 "--query", qpath, "--outdir", str(tmp_path / "x")]
                + common) == 0

    def top(d):
        with open(os.path.join(d, "epa_result.jplace")) as f:
            doc = json.load(f)
        return {p["n"][0]: p["p"][0][:2] for p in doc["placements"]}
    a, b = top(str(tmp_path / "x")), top(str(tmp_path / "b"))
    assert a.keys() == b.keys() and len(a) == 32
    same = [a[q][0] == b[q][0] and abs(a[q][1] - b[q][1])
            <= 1e-5 * abs(a[q][1]) for q in a]
    assert np.mean(same) >= 0.9


@pytest.mark.requires_cuda
def test_memsave_half_budget_on_card():
    """``--memsave`` at half the host store's size: the cached prefix's
    pairs through the blocked kernel, the streamed ones through the
    per-pair shape, both counted at the launch; placements agree with the
    resident engine on the card (best logl within 1e-5 relative, top edge
    up to ties) on >= 99% of queries. The built engine holds its cache on
    the device and no more; placing adds at most the resident engine's
    temporaries, its staging rings and 2 MB."""
    from epa_ng_tpu_torch.core.memsave import OutOfCoreEngine
    dev = _card()
    tree, ref, qry, _ = evolved_dataset(n_taxa=64, sites=200, n_queries=256,
                                        seed=21, model_str=GTR)
    opts = lambda **kw: Options(compute_dtype="f32", **kw)
    mb = lambda: torch.cuda.memory_allocated(dev) / 1e6

    def held(make):
        """(engine, MB it holds built, MB its exact path's placing adds,
        placements)"""
        torch.cuda.synchronize()
        base = mb()
        eng = make()
        torch.cuda.synchronize()
        rest = mb()
        torch.cuda.reset_peak_memory_stats(dev)
        got = eng._place_chunk_exact(eng.encode_msa(qry), 0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 1e6
        return eng, rest - base, peak - rest, got

    res, res_rest, res_temp, want = held(lambda: PlacementEngine(
        tree, ref, Model.from_string(GTR), opts(), device=dev))
    del res
    probe = OutOfCoreEngine(tree, ref, Model.from_string(GTR),
                            opts(memsave=True, memsave_budget_gb=0.0),
                            device=dev)
    half = probe.host_resident_bytes() / 2 / 1e9
    del probe
    before = bk.blo_newton.counts()
    eng, rest, temp, got = held(lambda: OutOfCoreEngine(
        tree, ref, Model.from_string(GTR),
        opts(memsave=True, memsave_budget_gb=half), device=dev))
    st = eng.memsave_stats()
    assert rest <= st["memsave_cached_mb"] + 0.25 < res_rest
    assert st["memsave_ring_mb"] <= st["memsave_ring_bound_mb"]
    assert temp <= res_temp + st["memsave_ring_mb"] + 2.0
    assert 0 < st["memsave_cached_edges"] < eng.num_edges
    assert st["memsave_hit_pairs"] > 0 and st["memsave_streamed_pairs"] > 0
    assert st["h2d_mb"] > 0
    after = bk.blo_newton.counts()
    per_pair, blocked = (after[k] - before[k]
                         for k in ("per_pair_launches", "blocked_launches"))
    assert per_pair > 0 and blocked > 0
    assert eng.newton_work.totals()["twin_launches"] == 0
    close, agree = _agreement(want, got)
    assert close >= 0.99 and agree >= 0.99


@pytest.mark.requires_cuda
@pytest.mark.parametrize("model", ["LG+G4{0.8}", "LG+G16{0.8}"],
                         ids=["lg", "lg16"])
def test_memsave_budget_zero_on_card(model):
    """``--memsave`` at budget 0 past DNA G4: every pair of the exact path
    streamed to the per-pair shape at K = 20 (LG+G4) and on the cluster
    (LG+G16), counted at the launch, never the blocked shape or the twin;
    placements agree with the resident engine on the card (best logl
    within 1e-5 relative, top edge up to ties) on >= 99% of queries, and
    the built engine holds nothing on the device but its constants."""
    from epa_ng_tpu_torch.core.memsave import OutOfCoreEngine
    dev = _card()
    tree, ref, qry, _ = evolved_dataset(n_taxa=32, sites=200, n_queries=96,
                                        seed=21, model_str="LG+G4{0.8}",
                                        alphabet=AA)
    opts = lambda **kw: Options(compute_dtype="f32", **kw)
    res = PlacementEngine(tree, ref, Model.from_string(model), opts(),
                          device=dev)
    want = res._place_chunk_exact(res.encode_msa(qry), 0)
    del res
    before = bk.blo_newton.counts()
    eng = OutOfCoreEngine(tree, ref, Model.from_string(model),
                          opts(memsave=True, memsave_budget_gb=0.0),
                          device=dev)
    got = eng._place_chunk_exact(eng.encode_msa(qry), 0)
    after = bk.blo_newton.counts()
    st = eng.memsave_stats()
    assert st["memsave_cached_edges"] == 0 and st["memsave_cached_mb"] == 0
    assert st["memsave_hit_pairs"] == 0 and st["memsave_streamed_pairs"] > 0
    per_pair, blocked, cluster = (after[k] - before[k] for k in (
        "per_pair_launches", "blocked_launches", "cluster_launches"))
    assert per_pair > 0 and blocked == 0
    assert cluster == (per_pair if "G16" in model else 0)
    assert eng.newton_work.totals()["twin_launches"] == 0
    close, agree = _agreement(want, got)
    assert close >= 0.99 and agree >= 0.99


@pytest.mark.requires_cuda
def test_mesh_on_one_card():
    """Two ep shards on the one card (``make_mesh(1, 2, [cuda:0] * 2)``):
    the engine is built on the CPU in f32, as the CLI builds it under
    --mesh, and every shard places through the blocked kernel (at least
    one launch a shard a chunk), never the twin; its exact redo runs the
    per-pair shape on windows of the host store. Placements agree with the
    resident engine on the card: top edge up to ties on >= 99% of queries
    and the best logl within chip_smoke.MEMSAVE_LOGL_ABS where the top
    edge is shared (the two builds round apart), and the exact redo's
    pairs within it too."""
    from chip_smoke import MEMSAVE_LOGL_ABS
    _mesh_on_one_card(GTR, "ACGT", MEMSAVE_LOGL_ABS)


@pytest.mark.requires_cuda
def test_mesh_on_one_card_protein():
    """test_mesh_on_one_card under LG+G4 on protein reads: the K = 20
    blocked shape on both shards, its per-pair shape in the exact redo,
    held to four f32 spacings at the resident run's largest |best logl|
    (chip_smoke.f32_steps)."""
    _mesh_on_one_card("LG+G4{0.8}", AA, None)


def _mesh_on_one_card(model, alphabet, tol):
    """test_mesh_on_one_card's body under ``model`` on reads evolved over
    ``alphabet``; ``tol`` None: four f32 spacings at the resident run's
    largest |best logl|."""
    from epa_ng_tpu_torch.parallel.mesh import make_mesh
    dev = _card()
    tree, ref, qry, _ = evolved_dataset(n_taxa=64, sites=200, n_queries=256,
                                        seed=21, model_str=model,
                                        alphabet=alphabet)
    make = lambda d: PlacementEngine(tree, ref, Model.from_string(model),
                                     Options(compute_dtype="f32"), device=d)
    res = make(dev)
    want = res.place_chunk(qry)
    if tol is None:
        tol = 4 * float(np.spacing(np.float32(max(
            abs(p.logls[0]) for p in want))))
    eng = make("cpu")
    eng.attach_mesh(make_mesh(1, 2, [dev] * 2))
    assert eng.device == dev and eng._sharded.pad == 1
    before = bk.blo_newton.counts()
    got = eng.place_chunk(qry)
    after = bk.blo_newton.counts()
    assert after["blocked_launches"] - before["blocked_launches"] >= 2
    assert eng.newton_work.totals()["twin_launches"] == 0
    _, agree = _agreement(want, got)
    assert agree >= 0.99
    shared = [abs(y.logls[0] - x.logls[0]) for x, y in zip(want, got)
              if x.edge_nums[0] == y.edge_nums[0]]
    assert len(shared) >= 0.9 * len(want)
    assert max(shared) <= tol

    ec = eng.encode_msa(qry)
    perm = np.argsort(ec.ranges[:, 0], kind="stable")
    codes, ranges = ec.codes[perm], ec.ranges[perm]
    before = bk.blo_newton.counts()["per_pair_launches"]
    redo = [eng._redo_exact([0, 1, 2], codes, ranges,
                            *e._query_tensors_codes(codes), perm,
                            ec.headers, 0) for e in (eng, res)]
    assert bk.blo_newton.counts()["per_pair_launches"] > before
    for x, y in zip(*redo):
        assert x.seq_id == y.seq_id
        common = set(x.edge_nums.tolist()) & set(y.edge_nums.tolist())
        assert common
        lx = dict(zip(x.edge_nums.tolist(), x.logls.tolist()))
        ly = dict(zip(y.edge_nums.tolist(), y.logls.tolist()))
        assert max(abs(lx[e] - ly[e]) for e in common) <= tol


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", ["gtr_g4", "lg_g4", "mixture"])
@pytest.mark.parametrize("heuristic", ["fixed", "baseball"])
def test_exact_budgets_wide_on_card(tmp_path, monkeypatch, cell,
                                    heuristic):
    """``-G 0.1`` and ``--baseball-heur`` past GTR+G16: GTR+G4, LG+G4 and
    the four-component mixture on small references (chip_smoke's
    EXACT_CELLS, seed 5) place through their own instantiation alone,
    never the twin, and agree with the port's f64 CPU run (top edge up to
    ties on >= 99% of reads, best logl within 1e-5 relative): phase 5's
    ``exact_budgets_wide``."""
    import chip_smoke as cs
    _card()
    monkeypatch.setattr(cs, "OUT", str(tmp_path))
    cs.register_mixture()
    res = cs.exact_budgets("cuda", {heuristic: cs.EXACT_BUDGETS[heuristic]},
                           **cs.EXACT_CELLS[cell])[heuristic]
    assert res["launches"] > 0 and res["twin_launches"] == 0
    assert res["agreement"]["top_edge_up_to_ties"] >= 0.99


@pytest.fixture()
def small_run(tmp_path, monkeypatch):
    """chip_smoke writing under ``tmp_path``, and its small reference
    (GTR+G4, 32 taxa x 200 sites, 96 reads, seed 5) run on the card and
    in f64 on the CPU."""
    import chip_smoke as cs
    _card()
    monkeypatch.setattr(cs, "OUT", str(tmp_path))
    cs.small_reference("cuda", size=(32, 200, 96, 16))
    return cs


@pytest.mark.requires_cuda
def test_lookup_bf16_on_card(small_run):
    """``--lookup-dtype bf16`` (the residual preplacement GEMM in bf16) on
    the card ranks as the f32 table does: the top edge up to ties on >=
    99% of the reads (chip_smoke.lookup_bf16, phase 5b)."""
    cs = small_run
    cs.main_path(cs.small_paths(), 96, None, "cuda", name="base", chunk=256)
    res = cs.lookup_bf16("cuda", "base", cs.small_paths(), 96, None,
                         cs.MODEL, "k4_launches", 256)
    assert res["agreement"]["top_edge_up_to_ties"] >= 0.99


@pytest.mark.requires_cuda
@pytest.mark.parametrize("key", ["f64", "pallas_off"])
def test_twin_flags_on_card(small_run, key):
    """``--compute-dtype f64`` and ``--pallas off`` (f32) run the torch
    twin on the card, no kernel, and agree with the f64 CPU run: f64
    within 1e-8 absolute, f32 within 1e-5 relative
    (chip_smoke.twin_on_card, phase 5b)."""
    res = small_run.twin_on_card("cuda", key)
    assert res["twin_launches"] > 0


@pytest.mark.requires_cuda
def test_no_pre_mask_on_card(small_run):
    """``--no-pre-mask`` places through the kernel on the card and agrees
    with the f64 CPU run (chip_smoke.no_pre_mask, phase 5b)."""
    res = small_run.no_pre_mask("cuda")
    assert res["launches"]["launches"] > 0


@pytest.mark.requires_cuda
def test_bfast_places_on_card(small_run):
    """A ``-c`` bfast file placed on the card gives the FASTA file's jplace
    but for the invocation line (chip_smoke.bfast_round_trip, phase
    5b)."""
    res = small_run.bfast_round_trip("cuda", small_run.small_paths())
    assert res["identical"] and res["placements"] > 0

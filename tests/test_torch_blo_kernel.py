"""The CUDA Newton kernel's plain version (ops.blo_kernel) against the JAX
package's Pallas kernels run in interpret mode, on the same pairs, the
same ``_kernel_scalars`` and f32 on the CPU (the kernel itself is held
against its plain version on the card by tests/test_torch_cuda.py).

Tolerances are tests/test_pallas.py's: logl within 0.05 absolute (f32 sums
over a few hundred sites, taken in another order), and branch lengths by
the 0.9 quantile (< 0.01) over logl-sharp pairs plus a loose max, because
on a logl-flat pair the Newton-decrement stop bounds the forgone logl, not
the length — two rounding-divergent trajectories may stop a crawl step
apart while their logl agrees.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from epa_ng_tpu.core.engine import PlacementEngine
from epa_ng_tpu.models import Model
from epa_ng_tpu.ops import pallas_blo as jpb
from epa_ng_tpu.utils.options import Options
from epa_ng_tpu.utils.synth import synth_dataset

from epa_ng_tpu_torch.core.engine import state_from_numpy
from epa_ng_tpu_torch.ops import blo_kernel as bk
from epa_ng_tpu_torch.ops import newton as tnewton

# one intra-op thread per test process: the suite runs in parallel
# workers, and a thread per core in each of them oversubscribes the
# CPU and slows the small tensor ops here by orders of magnitude
torch.set_num_threads(1)

GTR = "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G4{0.6}"
S = 200


def T(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def f32_state():
    tree, ref, qry = synth_dataset(n_taxa=24, sites=S, n_queries=16, seed=9)
    eng = PlacementEngine(tree, ref, Model.from_string(GTR),
                          Options(compute_dtype="f32"))
    codes, qmasks, ranges = eng._encode_chunk(qry)
    tQ, invq = eng._query_tensors(qmasks)
    tconsts, tblo, _ = state_from_numpy(eng.consts, eng.blo,
                                        eng.lookup_table, device="cpu")
    return dict(eng=eng, blo=eng.blo, tblo=tblo, tQ=tQ, ranges=ranges,
                tconsts=tconsts)


def _pairs(st, P, seed):
    rng = np.random.default_rng(seed)
    pe = rng.integers(0, st["eng"].num_edges, P).astype(np.int32)
    pq = rng.integers(0, 16, P).astype(np.int32)
    order = np.argsort(st["ranges"][pq, 0], kind="stable")
    pe, pq = pe[order], pq[order]
    pb = st["ranges"][pq, 0].astype(np.int32)
    sp = st["ranges"][pq, 1].astype(np.int32)
    return pe, pq, pb, sp


def _compare(ref, got, sharp_tol=1e-3):
    ref = [np.asarray(x) for x in ref]
    got = [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
           for x in got]
    logl_diff = np.abs(ref[0] - got[0])
    assert logl_diff.max() < 0.05, logl_diff.max()
    sharp = logl_diff < sharp_tol
    assert sharp.mean() > 0.9
    for i in (1, 2):
        d = np.abs(ref[i] - got[i])[sharp]
        assert np.quantile(d, 0.9) < 0.01
        assert d.max() < 10.0
    assert got[5].dtype == np.bool_


def test_plain_matches_pallas_blocked_interpret(f32_state):
    """Blocked call shape: the JAX kernel gets row-gathered tensors and a
    mask relative to each 128-pair block's window; the port reads the full
    stores by id with per-pair (begin, span) windows, its sumtable only as
    wide as the widest span."""
    st = f32_state
    blo, tQ = st["blo"], st["tQ"]
    pe, pq, pb, sp = _pairs(st, 256, seed=3)
    offs, Wb = jpb.plan_blocks_pairs(pb, pb + sp, S)
    Wk = bk.kernel_width(sp)
    assert Wk % 32 == 0 and sp.max() <= Wk <= Wb
    local = pb - np.repeat(offs, jpb.PB)
    w = np.arange(Wb)
    bmask = ((w[None] >= local[:, None])
             & (w[None] < (local + sp)[:, None])).astype(np.float32)
    site = np.arange(S)
    full = ((site[None] >= pb[:, None])
            & (site[None] < (pb + sp)[:, None])).astype(np.float32)
    ls_sum = (full * np.asarray(blo.ls)[pe]).sum(1).astype(np.float32)
    ref = jpb.blo_optimize_batch_pallas_blocked(
        st["eng"].consts, blo.tU[pe], blo.tV[pe], tQ[pq],
        jnp.asarray(bmask), blo.lengths[pe], jnp.asarray(offs),
        jnp.asarray(ls_sum), block_width=Wb, interpret=True)
    before = bk.blo_newton.launches
    tb = st["tblo"]
    got = bk.blo_optimize_batch_kernel_blocked(
        st["tconsts"], tb.tU, tb.tV, T(tQ), T(pe), T(pq), T(pb), T(sp),
        tb.lengths[T(pe).long()], T(ls_sum), Wk)
    assert bk.blo_newton.launches == before  # the plain version never counts
    _compare(ref, got)
    # tight where both agree the pair is sharp: the same arithmetic
    rel = np.abs(np.asarray(ref[0]) - got[0].numpy()) / np.abs(
        np.asarray(ref[0]))
    assert np.median(rel) < 1e-6


def test_plain_matches_pallas_per_pair_interpret(f32_state):
    """Per-pair call shape (pre-sliced [B, RK, W] windows, as the engine's
    bucketed path cuts them)."""
    st = f32_state
    blo, tQ = st["blo"], st["tQ"]
    pe, pq, pb, sp = _pairs(st, 40, seed=1)
    W = 128
    assert sp.max() <= W
    wb = np.minimum(pb, S - W)
    idx = wb[:, None] + np.arange(W)[None]
    local = pb - wb
    w = np.arange(W)
    sm = ((w[None] >= local[:, None])
          & (w[None] < (local + sp)[:, None])).astype(np.float32)
    inv = np.full(sm.shape, -np.inf, np.float32)
    cut = lambda x, rows: np.take_along_axis(
        np.asarray(x)[rows], idx[:, None, :], axis=2)
    args = (cut(blo.tU, pe), cut(blo.tV, pe), cut(tQ, pq),
            np.take_along_axis(np.asarray(blo.ls)[pe], idx, axis=1), sm,
            np.asarray(blo.lengths)[pe], inv)
    args = tuple(jnp.asarray(a) for a in args)
    ref = jpb.blo_optimize_batch_pallas(st["eng"].consts, *args,
                                        interpret=True)
    got = bk.blo_optimize_batch_kernel(st["tconsts"], *[T(a) for a in args])
    _compare(ref, got)
    # the +I call shape with pinv = 0 and no invariant term is the same
    # arithmetic exactly (omp * f + 0 == f), and matches the JAX +I kernel
    got_i = bk.blo_optimize_batch_kernel(st["tconsts"], *[T(a) for a in args],
                                         has_pinv=True)
    for a, b in zip(got, got_i):
        assert torch.equal(a, b)
    ref_i = jpb.blo_optimize_batch_pallas(st["eng"].consts, *args,
                                          interpret=True, has_pinv=True)
    _compare(ref_i, got_i)


PINV = ("GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}"
        "+G4{0.6}+I{0.25}")


@pytest.fixture(scope="module")
def pinv_state():
    """+I state on random data with invariant columns (16 taxa: about 4%
    of random columns are invariant; the queries' random characters meet
    their state a quarter of the time)."""
    tree, ref, qry = synth_dataset(n_taxa=16, sites=S, n_queries=16,
                                   seed=21)
    eng = PlacementEngine(tree, ref, Model.from_string(PINV),
                          Options(compute_dtype="f32"))
    assert eng.model.pinv == 0.25
    codes, qmasks, ranges = eng._encode_chunk(qry)
    tQ, invq = eng._query_tensors(qmasks)
    assert np.isfinite(np.asarray(invq)).any()
    tconsts, tblo, _ = state_from_numpy(eng.consts, eng.blo,
                                        eng.lookup_table, device="cpu")
    return dict(eng=eng, blo=eng.blo, tblo=tblo, tQ=tQ, invq=invq,
                ranges=ranges, tconsts=tconsts)


def _assert_pv_bites(st, pe, pq, pb, sp):
    """The pairs' invariant term is non-zero on some in-span site, so the
    comparison is not vacuous."""
    lin = np.exp(np.asarray(st["invq"])[pq] - np.asarray(st["blo"].ls)[pe])
    site = np.arange(S)
    span = (site[None] >= pb[:, None]) & (site[None] < (pb + sp)[:, None])
    assert (lin[span] > 0).mean() > 0.005


def test_plain_matches_pallas_blocked_pinv_interpret(pinv_state):
    """K2: the +I blocked call shape. The JAX kernel gets the materialised
    per-(pair, site) term pinv_lin = exp(invq[q] - ls[e]) [NP, S]; the port
    reads invq and ls by query and edge id."""
    st = pinv_state
    blo, tQ, invq = st["blo"], st["tQ"], st["invq"]
    pe, pq, pb, sp = _pairs(st, 256, seed=4)
    _assert_pv_bites(st, pe, pq, pb, sp)
    offs, Wb = jpb.plan_blocks_pairs(pb, pb + sp, S)
    Wk = bk.kernel_width(sp)
    local = pb - np.repeat(offs, jpb.PB)
    w = np.arange(Wb)
    bmask = ((w[None] >= local[:, None])
             & (w[None] < (local + sp)[:, None])).astype(np.float32)
    site = np.arange(S)
    full = ((site[None] >= pb[:, None])
            & (site[None] < (pb + sp)[:, None])).astype(np.float32)
    ls_sum = (full * np.asarray(blo.ls)[pe]).sum(1).astype(np.float32)
    ref = jpb.blo_optimize_batch_pallas_blocked(
        st["eng"].consts, blo.tU[pe], blo.tV[pe], tQ[pq],
        jnp.asarray(bmask), blo.lengths[pe], jnp.asarray(offs),
        jnp.asarray(ls_sum), block_width=Wb, interpret=True,
        pinv_lin=jnp.exp(invq[pq] - blo.ls[pe]))
    tb = st["tblo"]
    got = bk.blo_optimize_batch_kernel_blocked(
        st["tconsts"], tb.tU, tb.tV, T(tQ), T(pe), T(pq), T(pb), T(sp),
        tb.lengths[T(pe).long()], T(ls_sum), Wk, invq=T(invq), ls=tb.ls)
    _compare(ref, got)
    rel = np.abs(np.asarray(ref[0]) - got[0].numpy()) / np.abs(
        np.asarray(ref[0]))
    assert np.median(rel) < 1e-6
    # the invariant term moves the answer: with it zeroed the logl differs
    no_pv = bk.blo_optimize_batch_kernel_blocked(
        st["tconsts"], tb.tU, tb.tV, T(tQ), T(pe), T(pq), T(pb), T(sp),
        tb.lengths[T(pe).long()], T(ls_sum), Wk,
        invq=torch.full_like(T(invq), -torch.inf), ls=tb.ls)
    assert (no_pv[0] - got[0]).abs().max() > 0.05


def _per_pair_args(st, pe, pq, pb, sp, W, inv):
    blo, tQ = st["blo"], st["tQ"]
    wb = np.minimum(pb, S - W)
    idx = wb[:, None] + np.arange(W)[None]
    local = pb - wb
    w = np.arange(W)
    sm = ((w[None] >= local[:, None])
          & (w[None] < (local + sp)[:, None])).astype(np.float32)
    cut = lambda x, rows: np.take_along_axis(
        np.asarray(x)[rows], idx[:, None, :], axis=2)
    take = lambda x, rows: np.take_along_axis(np.asarray(x)[rows], idx,
                                              axis=1)
    args = (cut(blo.tU, pe), cut(blo.tV, pe), cut(tQ, pq),
            take(blo.ls, pe), sm, np.asarray(blo.lengths)[pe],
            take(inv, pq) if inv is not None
            else np.full(sm.shape, -np.inf, np.float32))
    return tuple(jnp.asarray(a) for a in args)


def test_plain_matches_pallas_per_pair_pinv_interpret(pinv_state):
    """K4: the +I per-pair call shape on pre-sliced windows; the port
    reads row b of inv_logfreq and ls for pair b."""
    st = pinv_state
    pe, pq, pb, sp = _pairs(st, 40, seed=2)
    _assert_pv_bites(st, pe, pq, pb, sp)
    W = 128
    assert sp.max() <= W
    args = _per_pair_args(st, pe, pq, pb, sp, W, st["invq"])
    ref = jpb.blo_optimize_batch_pallas(st["eng"].consts, *args,
                                        interpret=True, has_pinv=True)
    got = bk.blo_optimize_batch_kernel(st["tconsts"], *[T(a) for a in args],
                                       has_pinv=True)
    _compare(ref, got)
    rel = np.abs(np.asarray(ref[0]) - got[0].numpy()) / np.abs(
        np.asarray(ref[0]))
    assert np.median(rel) < 1e-6


def test_plain_counters_match_pallas_count_iters(f32_state):
    """K5: the port counts each pair's own executed smoothings and Newton
    iterations; the TPU kernel counts lock-step trips per 128-pair block.
    Per block whose pairs agree in logl within 1e-3, the block's smoothing
    count is the maximum of the port's per-pair smoothings, and its trip
    count (the sum over smoothings of the slowest lane's iterations, done
    lanes included) is at least the maximum of the per-pair iterations."""
    st = f32_state
    pe, pq, pb, sp = _pairs(st, 256, seed=7)
    W = 128
    args = _per_pair_args(st, pe, pq, pb, sp, W, None)
    ref = jpb.blo_optimize_batch_pallas(st["eng"].consts, *args,
                                        interpret=True, count_iters=True)
    got = bk.blo_optimize_batch_kernel(st["tconsts"], *[T(a) for a in args],
                                       counters=True)
    _compare(ref[:6], got[:6])
    smooth, iters = got[6].numpy(), got[7].numpy()
    assert ((smooth >= 1) & (smooth <= tnewton.SMOOTHINGS)).all()
    assert ((iters >= 2 * smooth)
            & (iters <= 2 * smooth * tnewton.MAX_ITERS)).all()
    # the counted run is the same run
    plain = bk.blo_optimize_batch_kernel(st["tconsts"],
                                         *[T(a) for a in args])
    assert torch.equal(plain[0], got[0])
    trips, jsmooth = np.asarray(ref[6]), np.asarray(ref[7])
    agree = (np.abs(np.asarray(ref[0]) - got[0].numpy()) < 1e-3).reshape(
        -1, jpb.PB).all(axis=1)
    assert agree.sum() >= 1
    for b in np.nonzero(agree)[0]:
        blk = slice(b * jpb.PB, (b + 1) * jpb.PB)
        assert jsmooth[b] == smooth[blk].max()
        assert trips[b] >= iters[blk].max()


@pytest.fixture(scope="module")
def model_consts(f32_state):
    """(JAX consts, port consts) in f32 of the GTR+G4 state, LG+G4, a
    four-component LG-derived matrix mixture (per-rate eigen systems) and
    a nine-component one (past 8 rate categories)."""
    from epa_ng_tpu.models import aa_matrices
    from epa_ng_tpu.ops import eigen as jeigen
    from epa_ng_tpu.ops import newton as jnewton
    from test_torch_blo_kernel_aa import mixture_components
    out = {"GTR": (f32_state["eng"].consts, f32_state["tconsts"])}
    aa_matrices.MIXTURES["TESTSCALARMIX"] = (mixture_components(4), "gamma")
    aa_matrices.MIXTURES["TESTSCALARMIX9"] = (mixture_components(9),
                                             "gamma")
    try:
        for name, model in (("LG", "LG+G4{0.8}"),
                            ("mixture", "TESTSCALARMIX+G4{0.9}"),
                            ("mixture9", "TESTSCALARMIX9+G9{0.9}")):
            jc = jnewton.eig_consts(
                jeigen.decompose(Model.from_string(model)), jnp.float32)
            out[name] = (jc, tnewton.EigConsts(*[T(x) for x in jc]))
    finally:
        aa_matrices.MIXTURES.pop("TESTSCALARMIX", None)
        aa_matrices.MIXTURES.pop("TESTSCALARMIX9", None)
    return out


@pytest.mark.parametrize("model", ["GTR", "LG", "mixture", "mixture9"])
def test_kernel_scalars_match(model_consts, model):
    jc, tc = model_consts[model]
    ref = jpb._kernel_scalars(jc, jnp.float32)
    got = bk._kernel_scalars(tc, torch.float32)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0])[:, 0])
    for r, g in zip(ref[1:], got[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r))
    # a mixture's A and piA are per-rate rows [RK, K]
    K, RK = 4 if model == "GTR" else 20, got[0].shape[0]
    mix = model.startswith("mixture")
    assert got[2].shape == ((RK, K) if mix else (K, K))
    if model == "mixture9":
        # nine components, one per rate category: past 8, within the cap
        assert RK == 180 and bk.blo_unsupported(tc) is None


@pytest.mark.parametrize("model", ["GTR", "LG", "mixture"])
def test_blo_supported_and_op_count(model_consts, model):
    c = model_consts[model][1]
    K = int(c.A.shape[-1])
    mix = c.A.ndim == 3
    assert bk.blo_unsupported(c) is None     # at any window width
    assert "sliding" in bk.blo_unsupported(c, sliding=False)
    c64 = tnewton.EigConsts(*[x.double() for x in c])
    assert "f32" in bk.blo_unsupported(c64)
    # 9 rate categories run (the runtime-R instantiation at K = 4, a
    # cluster of two CTAs at K = 20); one past the cap is refused by name
    c9 = c._replace(rates=torch.ones(9))
    assert bk.blo_unsupported(c9) is None
    cap = bk.MAX_RATES[(K, mix)]
    over = c._replace(rates=torch.ones(cap + 1))
    assert (f"{cap + 1} rate categories (the kernel takes 1..{cap}"
            in bk.blo_unsupported(over))
    # K = 4: one pair's T per CTA beside its tables, exponential rows and
    # warp slots (2,048 B), within 227 KB; T is site-major, its RK rows
    # (+1 with +I) padded to 4 mod 8 floats a site
    assert bk.max_shared_sites(16) == 2880
    assert bk.max_shared_sites(32) == 1600
    assert bk.max_shared_sites(16, has_pinv=True) == 2880
    assert [bk._t_stride(4, 4 * R, p) for R in (1, 2, 4, 8)
            for p in (False, True)] == [4, 12, 12, 12, 20, 20, 36, 36]
    assert bk._t_stride(20, 80, True) == 81
    # RK = 80: one team's T beside its scalar tables, exponential rows and
    # reduction buffers, in one CTA: 640 sites (608 for a mixture), with
    # or without +I
    assert bk.max_shared_sites(80, False, 20, mix) == (608 if mix else 640)
    assert bk.max_shared_sites(80, True, 20) == 640
    # past 8 rates each CTA of a cluster holds 8 rates' tables and T rows
    for R in range(1, bk.MAX_RATES[(20, True)] + 1):
        s = min(R, 8)
        rows, w = 20 * s, bk.max_shared_sites(20 * R, False, 20, True)
        fixed = (bk._tab_bytes(20, s, True) + bk._exp_bytes(20, s)
                 + bk._red_bytes(20))
        assert fixed + rows * w * 4 <= bk.SMEM_PER_BLOCK
        assert fixed + rows * (w + 32) * 4 > bk.SMEM_PER_BLOCK
    assert bk._exp_bytes(4) == 4 * 2 * 32 * 4
    assert bk._red_bytes(4) == 32 * 4
    assert bk._exp_bytes(20) == 8 * 2 * 32 * 4
    assert bk._red_bytes(20) == (2 * 3 * 512 + 32) * 4
    # the tables' sizes as csrc/blo_newton.cu lays them out
    assert bk._tab_bytes(4, 8) == 224 * 4
    assert bk._tab_bytes(20, 4) == -(-(80 + 1600 + 800) // 32) * 32 * 4
    assert bk._tab_bytes(20, 4, True) == -(-(80 + 3 * 1600) // 32) * 32 * 4
    assert bk.kernel_width(np.array([1, 200, 33])) == 224
    assert bk.kernel_width(np.array([2000])) == 2016
    # operation count grows with the executed work, and with +I
    a = bk.blo_op_count([100], [2], [10], 4, num_states=K)
    b = bk.blo_op_count([100], [3], [20], 4, num_states=K)
    assert 0 < a < b
    assert bk.blo_op_count([100], [2], [10], 4, has_pinv=True,
                           num_states=K) == a + 100 * (2 + 10 * 4 + 3 * 2)
    # a build per site and rate: 6 K^2 + K - 2 operations (98 at K = 4)
    build = (6 * K * K + K - 2) * 4
    newton_site = 6 * (4 * K - 4) + 4 + 8
    score_site = 2 * (4 * K - 4) + 4 + 3
    assert a == 100 * (5 * build + 3 * score_site + 10 * newton_site)
    # bytes: windows read once (+8 B per site with +I), ids and outputs;
    # a mixture's tip has RK rows
    RK = 4 * K
    kq = RK if mix else K
    assert bk.blo_byte_count([100], 4, num_states=K, mixture=mix) == (
        100 * (2 * RK + kq) * 4 + 44)
    assert bk.blo_byte_count([100], 4) == 100 * 144 + 44
    assert bk.blo_byte_count([100], 4, True, True) == 100 * 152 + 52


def _team_sum_loop(row, tile, warps):
    """The kernel's site order for one pair, written out in float32: each
    of the first ``tile`` threads adds its sites t, t + tile, ... from 0;
    each warp's xor butterfly; the warps' fixed tree."""
    f = np.float32
    threads = [f(0.0)] * (32 * warps)
    for t in range(tile):
        for w in range(t, len(row), tile):
            threads[t] = f(threads[t] + row[w])
    sums = []
    for wp in range(warps):
        v = threads[32 * wp:32 * wp + 32]
        for m in (16, 8, 4, 2, 1):
            v = [f(v[i] + v[i ^ m]) for i in range(32)]
        assert len(set(v)) == 1       # every lane holds the same float
        sums.append(v[0])
    h = warps // 2
    while h:
        sums = [f(sums[i] + sums[i + h]) for i in range(h)]
        h //= 2
    return sums[0]


@pytest.mark.parametrize("K,R,width", [(4, 4, 200), (4, 2, 330),
                                       (4, 4, 256), (20, 4, 128),
                                       (20, 4, 300), (20, 3, 352),
                                       (4, 9, 200), (4, 16, 330),
                                       (20, 9, 128), (20, 16, 300)])
def test_team_site_sum_order(K, R, width):
    """``team_site_sum`` adds a window's sites in the kernel's order: at
    K = 4 the team of 128 threads (one tile of 128 sites per pass, the
    butterfly, a tree over 4 warps) at every rate count, at widths below,
    above and at a multiple of the tile; at K = 20 the team (a tile of
    32 x 8/R sites per pass up to 8 rates, of 32 sites past them, where
    every CTA of a cluster adds its tile; the butterfly, a tree over 8
    warps); bit for bit against the order written out, and within 1e-5
    relative of the f64 sum."""
    tile = bk.kernel_geometry(K, R, width)["tile"]
    warps = bk._team(K) // 32
    assert tile == (128 if K == 4 else 32 * max(1, 8 // R))
    rng = np.random.default_rng(K + R + width)
    x = rng.random((3, width)).astype(np.float32) * 10
    x[1, width // 2:] = 0.0           # a short span in a wide window
    got = bk.team_site_sum(torch.as_tensor(x), tile, warps).numpy()
    want = np.array([_team_sum_loop(r, tile, warps) for r in x])
    np.testing.assert_array_equal(got, want)
    exact = x.astype(np.float64).sum(axis=1)
    np.testing.assert_allclose(got, exact, rtol=1e-5)


@pytest.mark.parametrize("shape", ["protein", "mixture", "pinv"])
def test_wide_geometry(shape):
    """The K = 20 team's geometry at the main paths' width (128 sites, R =
    4): 256 threads a pair (two units each), one CTA and 8 warps an SM (a
    team takes the register file), T within 227 KB of shared memory; and
    the boundary past which T moves to the device-memory scratch."""
    mix, pinv = shape == "mixture", shape == "pinv"
    g = bk.kernel_geometry(20, 4, 128, mix, pinv)
    assert g["threads"] == 256 and g["tile"] == 64
    assert g["ctas_per_sm"] == 1 and g["warps_per_sm"] == 8
    assert g["t_shared"]
    tab = bk._tab_bytes(20, 4, mix)
    assert g["shared_bytes"] == (tab + 2048 + (3072 + 32) * 4
                                 + (80 + pinv) * 128 * 4)
    assert g["shared_bytes"] == {"protein": 65408, "mixture": 75008,
                                 "pinv": 65920}[shape]
    shared = bk.max_shared_sites(80, pinv, 20, mix)
    at = bk.kernel_geometry(20, 4, shared, mix, pinv)
    assert at["t_shared"] and at["shared_bytes"] <= bk.SMEM_PER_BLOCK
    assert at["ctas_per_sm"] == 1
    dev = bk.kernel_geometry(20, 4, shared + 32, mix, pinv)
    assert not dev["t_shared"]
    assert dev["shared_bytes"] == tab + 2048 + (3072 + 32) * 4
    assert dev["warps_per_sm"] == 8


@pytest.mark.parametrize("K,R,mix,pinv,tab,shared_sites", [
    (4, 16, False, False, 416, 832), (4, 16, False, True, 416, 832),
    (4, 9, False, False, 256, 1568), (20, 9, False, False, 4160, 288),
    (20, 16, False, False, 4160, 288), (20, 16, False, True, 4160, 288),
    (20, 16, True, False, 9760, 256)])
def test_geometry_past_eight_rates(K, R, mix, pinv, tab, shared_sites):
    """The layout past 8 rate categories, as csrc/blo_newton.cu sets it up:
    K = 4 tables of 24 R + 32 floats (rounded up to 32) and two exponential
    rows of RK floats a warp, each lane filling every 32nd entry; K = 20 a
    cluster of ceil(R / 8) CTAs a pair, each laid out for 8 rates (``tab``
    floats of tables: its slice's rows, a single matrix's A and piA whole;
    a tile of 32 sites, one row of 32 exponentials a warp, reduction
    buffers of 512 units); T in shared memory up to ``shared_sites`` (272
    B a site at K = 4, R = 16, with or without +I; at K = 20 a CTA's 160
    rows, 640 B a site, so the protein windows keep the shared home), in
    device memory beyond; and the rate cap: at K = 4 one rate past which
    the tables and a 32-site tile of T with +I no longer fit, at K = 20
    8 rates in each of the 8 CTAs of a portable cluster."""
    s = R if K == 4 else min(R, 8)
    assert bk._tab_bytes(K, s, mix) == tab * 4
    warps = bk._team(K) // 32
    if K == 4:
        row = -(-4 * R // 32) * 32
        assert bk._t_stride(4, 4 * R, pinv) == (68 if R == 16 else 36)
    else:
        row = 32
        assert bk._red_bytes(20) == (6 * 512 + 32) * 4
    assert bk._exp_bytes(K, s) == warps * 2 * row * 4
    assert bk.max_shared_sites(K * R, pinv, K, mix) == shared_sites
    g = bk.kernel_geometry(K, R, shared_sites, mix, pinv)
    assert g["t_shared"] and g["shared_bytes"] <= bk.SMEM_PER_BLOCK
    assert g["tile"] == (128 if K == 4 else 32)
    assert g["cluster"] == (1 if K == 4 else -(-R // 8))
    dev = bk.kernel_geometry(K, R, shared_sites + 32, mix, pinv)
    assert not dev["t_shared"]
    assert dev["shared_bytes"] == (bk._tab_bytes(K, s, mix)
                                   + bk._exp_bytes(K, s) + bk._red_bytes(K))
    cap = bk.MAX_RATES[(K, mix)]
    assert cap == {(4, False): 312, (20, False): 64, (20, True): 64}[K, mix]
    if K == 4:
        fits = lambda r: (bk._team_fixed_bytes(K, r, mix)
                          + bk._round32(bk._t_stride(K, K * r, True) * 32)
                          * 4 <= bk.SMEM_PER_BLOCK)
        assert fits(cap) and not fits(cap + 1)
    else:
        assert cap == bk.CLUSTER_RATES * bk.MAX_CLUSTER
        assert bk.kernel_geometry(20, cap, 32, mix, True)["cluster"] == 8


@pytest.mark.parametrize("pinv", [False, True])
def test_dna_geometry(pinv):
    """The K = 4 team's geometry, as csrc/blo_newton.cu lays it out: 128
    threads a pair, thread t owning sites t, t + 128, ...; 2,048 B of
    tables (896), exponential rows (1,024) and warp slots (128) ahead of
    one pair's site-major T (20 floats a site at R = 4, with or without
    +I); CTAs per SM from the registers a thread takes (in units of 256 a
    warp within each of four partitions), the 228 KB of an SM (1 KB more a
    CTA) and its 2048 threads; and the home at the boundary widths."""
    g = bk.kernel_geometry(4, 4, 256, has_pinv=pinv, regs=64)
    assert g["threads"] == 128 and g["tile"] == 128 and g["t_shared"]
    assert g["shared_bytes"] == 2048 + 20 * 256 * 4 == 22528
    assert g["ctas_per_sm"] == 8 and g["warps_per_sm"] == 32
    # registers and shared memory each bound the occupancy
    assert bk.kernel_geometry(4, 4, 256, has_pinv=pinv,
                              regs=40)["ctas_per_sm"] == 9
    assert bk.kernel_geometry(4, 4, 256, has_pinv=pinv,
                              regs=72)["ctas_per_sm"] == 7
    assert bk.kernel_geometry(4, 4, 256, has_pinv=pinv)["ctas_per_sm"] == 2
    assert bk.kernel_geometry(4, 4, 128, has_pinv=pinv,
                              regs=32)["ctas_per_sm"] == 16
    widest = bk.max_shared_sites(16, pinv)
    assert widest == 2880
    at = bk.kernel_geometry(4, 4, widest, has_pinv=pinv, regs=64)
    assert at["t_shared"] and at["shared_bytes"] <= bk.SMEM_PER_BLOCK
    assert at["shared_bytes"] + 20 * 32 * 4 > bk.SMEM_PER_BLOCK
    assert at["ctas_per_sm"] == 1
    dev = bk.kernel_geometry(4, 4, widest + 32, has_pinv=pinv, regs=64)
    assert not dev["t_shared"] and dev["shared_bytes"] == 2048
    assert dev["ctas_per_sm"] == 8
    # every rate count's widest shared T fits beside the fixed part
    for R in range(1, bk.MAX_RATES[(4, False)] + 1):
        w = bk.max_shared_sites(4 * R, pinv)
        assert bk.kernel_geometry(4, R, w, has_pinv=pinv)["t_shared"]
        assert not bk.kernel_geometry(4, R, w + 32, has_pinv=pinv)["t_shared"]

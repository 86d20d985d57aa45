"""The f32 Newton stall: repaired in the port (ops.newton.cancelled, the
guarded snap, in the kernel's plain version and in the torch twin), left as
it is in the JAX package.

Where a pendant Newton steps to (or just above) its lower bound, a site
likelihood that is near zero there cancels in the eigenbasis sum to noise,
d1 and d2 explode, the solve stops there and the smoothing rolls the pair
back to its initial lengths: pendant -log(0.9), distal = proximal =
orig / 2, and a logl below the optimum. The JAX package's Pallas kernel
shares the arithmetic, so its f32 result shows that signature on the same
pairs; the port's f32 result agrees with its f64 one.
"""

import numpy as np
import jax.numpy as jnp
import torch

from epa_ng_tpu.core.engine import PlacementEngine as JEngine
from epa_ng_tpu.io.fasta import MSA as JMSA
from epa_ng_tpu.models import Model as JModel
from epa_ng_tpu.ops import pallas_blo as jpb
from epa_ng_tpu.utils.options import Options as JOptions
from epa_ng_tpu.utils.synth import evolved_dataset

from epa_ng_tpu_torch.core.engine import PlacementEngine, state_from_numpy
from epa_ng_tpu_torch.io.fasta import MSA
from epa_ng_tpu_torch.models import Model
from epa_ng_tpu_torch.ops import blo_kernel as bk
from epa_ng_tpu_torch.ops.newton import DEFAULT_PENDANT
from epa_ng_tpu_torch.utils.options import Options

# one intra-op thread per test process: the suite runs in parallel
# workers, and a thread per core in each of them oversubscribes the
# CPU and slows the small tensor ops here by orders of magnitude
torch.set_num_threads(1)

GTR = "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G4{0.6}"
# (query, edge) pairs of the DNA headline data (chip_smoke.py: 512 taxa x
# 512 sites, 8192 evolved reads, seed 0) that stall in f32
STALLED = ((144, 214), (249, 107), (372, 206), (17, 899), (562, 385))


def T(x):
    return torch.as_tensor(np.array(x))


def _unguarded(monkeypatch):
    """The plain version without the guarded snap (the stall as it was)."""
    monkeypatch.setattr(bk, "cancelled",
                        lambda d1, x, lam_span: torch.zeros_like(
                            x, dtype=torch.bool))


def test_stall_repaired_in_the_port_not_in_the_jax_kernel(monkeypatch):
    """One 128-pair block: the five stalled pairs and their reads' best 123
    preplacement candidates, 256-site windows, through the JAX Pallas
    kernel in interpret mode (K3) and the port's plain version, f32. On
    the stalled pairs the JAX kernel shows the stall's signature and the
    port agrees with its f64 plain version (as the port did not before the
    guard); on the others both agree by tests/test_pallas.py's rule."""
    tree, ref, qry, _ = evolved_dataset(n_taxa=512, sites=512,
                                        n_queries=8192, seed=0)
    seqs = list(qry)
    queries = sorted({q for q, _ in STALLED})
    sub = JMSA()
    for q in queries:
        sub.append(seqs[q].header, seqs[q].sequence)
    eng = JEngine(tree, ref, JModel.from_string(GTR),
                  JOptions(compute_dtype="f32"))
    codes, qmasks, ranges = eng._encode_chunk(sub)
    tQ, _ = eng._query_tensors(qmasks)
    # the rest of the block: each read's best preplacement candidates, as
    # the main path pairs them
    n = len(STALLED)
    top = np.argsort(-np.asarray(eng.preplace(codes, ranges)), axis=1,
                     kind="stable")
    pairs = [(queries.index(q), e) for q, e in STALLED]
    for rank in range(top.shape[1]):
        for r in range(len(queries)):
            if len(pairs) < jpb.PB and (r, top[r, rank]) not in pairs:
                pairs.append((r, int(top[r, rank])))
    pq = np.array([q for q, _ in pairs], np.int32)
    pe = np.array([e for _, e in pairs], np.int32)
    S, W = 512, 256
    pb = ranges[pq, 0].astype(np.int32)
    sp = ranges[pq, 1].astype(np.int32)
    wb = np.minimum(pb, S - W)
    idx = wb[:, None] + np.arange(W)[None]
    local = pb - wb
    w = np.arange(W)
    sm = ((w[None] >= local[:, None])
          & (w[None] < (local + sp)[:, None])).astype(np.float32)
    cut = lambda x, rows: np.take_along_axis(np.asarray(x)[rows],
                                             idx[:, None, :], axis=2)
    # no +I term and no log-scale sums: the logl in the scaled space,
    # hundreds of units, where the interpret-mode rule's 1e-3 is resolved
    args = (cut(eng.blo.tU, pe), cut(eng.blo.tV, pe), cut(tQ, pq),
            np.zeros(sm.shape, np.float32), sm,
            np.asarray(eng.blo.lengths)[pe],
            np.full(sm.shape, -np.inf, np.float32))
    ref = [np.asarray(x) for x in jpb.blo_optimize_batch_pallas(
        eng.consts, *[jnp.asarray(a) for a in args], interpret=True)]
    tconsts, _, _ = state_from_numpy(eng.consts, eng.blo, eng.lookup_table,
                                     device="cpu")
    got = [x.numpy() for x in bk.blo_optimize_batch_kernel(
        tconsts, *[T(a) for a in args])]
    c64 = tconsts._replace(**{f: getattr(tconsts, f).double()
                              for f in tconsts._fields})
    f64 = [x.numpy() for x in bk.blo_optimize_batch_kernel(
        c64, *[T(a).double() for a in args])]
    orig = args[5]
    for i in range(n):
        # the JAX kernel: rolled back to the initial lengths, logl lost
        assert ref[1][i] == np.float32(DEFAULT_PENDANT), STALLED[i]
        assert ref[3][i] == ref[4][i] == np.float32(orig[i] * 0.5)
        assert ref[0][i] < f64[0][i] - 1.0
        # the port: the f64 optimum, in f32
        assert abs(got[0][i] - f64[0][i]) < 0.05, STALLED[i]
        assert abs(got[1][i] - f64[1][i]) < 1e-3
    # the rest by the interpret-mode rule
    rest = slice(n, None)
    diff = np.abs(ref[0] - got[0])[rest]
    assert diff.max() < 0.05
    sharp = diff < 1e-3
    assert sharp.mean() > 0.9
    for k in (1, 2):
        d = np.abs(ref[k] - got[k])[rest][sharp]
        assert np.quantile(d, 0.9) < 0.01
    # without the guarded snap the port stalled on the same pairs
    _unguarded(monkeypatch)
    old = [x.numpy() for x in bk.blo_optimize_batch_kernel(
        tconsts, *[T(a) for a in args])]
    assert (old[1][:n] == np.float32(DEFAULT_PENDANT)).all()
    assert (old[0][:n] < f64[0][:n] - 1.0).all()
    np.testing.assert_array_equal(old[0][n:], got[0][n:])


def test_lg_ic_g4_small_reference_f32_within_gate(monkeypatch):
    """chip_smoke.py's LG+IC+G4 small reference on its default seed 5 (48
    taxa x 200 sites, 20% invariant columns), cut to its first 16 reads:
    the port's f32 runs, through the torch twin and through the kernel's
    plain version (the engine's kernel routing on CPU tensors), place every
    read with a best logl within 1e-5 relative of the f64 run's. On this
    data the pair (read 42, edge 75) of the JAX package's f32 reference
    state stalls in f32 without the guarded snap; with it the plain
    version reaches the f64 optimum there."""
    from chip_smoke import (AA, AA_IC_MODEL, AA_MODEL, INVARIANT_SHARE,
                            lg_freqs, with_invariant_sites)
    from epa_ng_tpu_torch.utils.synth import evolved_dataset as t_evolved
    tree, ref, qry, _ = t_evolved(n_taxa=48, sites=200, n_queries=128,
                                  seed=5, model_str=AA_MODEL, alphabet=AA)
    ref, qry, _ = with_invariant_sites(ref, qry, lg_freqs(),
                                       INVARIANT_SHARE, 5, AA)
    reads = MSA()
    for i, seq in enumerate(qry):
        if i < 16:
            reads.append(seq.header, seq.sequence)
    model = Model.from_string(AA_IC_MODEL)
    engines = {}
    for name, dtype in (("f64", "f64"), ("twin", "f32"), ("plain", "f32")):
        eng = PlacementEngine(tree, ref, model,
                              Options(compute_dtype=dtype, chunk_size=64),
                              device="cpu")
        if name == "plain":
            monkeypatch.setattr(eng, "_use_kernel", lambda eng=eng: (
                bk.blo_unsupported(eng.consts) is None))
        engines[name] = eng
    best = {name: [p.logls[0] for p in eng.place_chunk(reads)]
            for name, eng in engines.items()}
    for name in ("twin", "plain"):
        rel = np.abs(np.subtract(best[name], best["f64"])) / np.abs(
            best["f64"])
        assert rel.max() <= 1e-5, (name, rel.max())
    # a pair of this data that stalls in f32 on the JAX package's f32
    # reference state (read 42, edge 75): the guarded plain version
    # reaches its f64 optimum there, the unguarded one stalls
    jeng = JEngine(tree, ref, JModel.from_string(AA_IC_MODEL),
                   JOptions(compute_dtype="f32"))
    sub = JMSA()
    sub.append(list(qry)[42].header, list(qry)[42].sequence)
    codes, qmasks, ranges = jeng._encode_chunk(sub)
    tQ, invq = jeng._query_tensors(qmasks)
    tconsts, _, _ = state_from_numpy(jeng.consts, jeng.blo,
                                     jeng.lookup_table, device="cpu")
    S = tQ.shape[2]
    site = np.arange(S)
    sm = ((site >= ranges[0, 0])
          & (site < ranges[0, 0] + ranges[0, 1])).astype(np.float32)[None]
    blo = jeng.blo
    args = (np.asarray(blo.tU)[[75]], np.asarray(blo.tV)[[75]],
            np.asarray(tQ), np.asarray(blo.ls)[[75]], sm,
            np.asarray(blo.lengths)[[75]], np.asarray(invq))
    c64 = tconsts._replace(**{f: getattr(tconsts, f).double()
                              for f in tconsts._fields})
    run = lambda c, dt: bk.blo_optimize_batch_kernel(
        c, *[T(a).to(dt) for a in args], has_pinv=True)
    f32, f64 = run(tconsts, torch.float32), run(c64, torch.float64)
    assert abs(float(f32[0]) - float(f64[0])) < 0.05
    _unguarded(monkeypatch)
    stalled = run(tconsts, torch.float32)
    assert float(stalled[1]) == np.float32(DEFAULT_PENDANT)
    assert float(stalled[0]) < float(f64[0]) - 0.05

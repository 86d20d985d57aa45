"""Port parity, end to end: the PyTorch engine and CLI against the JAX
package's on the same files, f64 on the CPU.

Every query's ``edge_num`` list must be identical; ``likelihood``,
``like_weight_ratio``, ``pendant_length`` and ``distal_length`` agree
within 1e-6 relative (the jplace prints 10 significant digits; the two
packages sum in another order).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from epa_ng_tpu.cli import main as jax_main
from epa_ng_tpu.core.engine import PlacementEngine as JEngine
from epa_ng_tpu.models import Model as JModel
from epa_ng_tpu.ops import clv as jclv
from epa_ng_tpu.ops import eigen as jeigen
from epa_ng_tpu.utils.options import Options as JOptions
from epa_ng_tpu.utils.synth import evolved_dataset, synth_files, write_fasta

from epa_ng_tpu_torch.cli import main as torch_main
from epa_ng_tpu_torch.core.engine import PlacementEngine, _check_device_model
from epa_ng_tpu_torch.io.fasta import MSA
from epa_ng_tpu_torch.models import Model
from epa_ng_tpu_torch.tree import Tree
from epa_ng_tpu_torch.utils.options import Options

# one intra-op thread per test process: the suite runs in parallel
# workers, and a thread per core in each of them oversubscribes the
# CPU and slows the small tensor ops here by orders of magnitude
torch.set_num_threads(1)

GTR = "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G4{0.6}"


def _placements(path):
    with open(path) as f:
        doc = json.load(f)
    fields = doc["fields"]
    out = {}
    for p in doc["placements"]:
        rows = [dict(zip(fields, r)) for r in p["p"]]
        for n in p["n"]:
            out[n] = rows
    return out


def assert_same_placements(a, b, rtol=1e-6):
    assert a.keys() == b.keys()
    for name in a:
        ra, rb = a[name], b[name]
        assert [r["edge_num"] for r in ra] == [r["edge_num"] for r in rb], \
            name
        for x, y in zip(ra, rb):
            for f in ("likelihood", "like_weight_ratio", "pendant_length",
                      "distal_length"):
                assert y[f] == pytest.approx(x[f], rel=rtol, abs=1e-12), \
                    (name, f)


def _run_both(tmp_path, tpath, rpath, qpath, model, extra=()):
    common = ["--tree", tpath, "--ref-msa", rpath, "--query", qpath,
              "--model", model, "--redo", *extra]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_main(common + ["--outdir", jdir]) == 0
    assert torch_main(common + ["--outdir", tdir, "--device", "cpu"]) == 0
    return (_placements(os.path.join(jdir, "epa_result.jplace")),
            _placements(os.path.join(tdir, "epa_result.jplace")))


def test_cli_parity_synth_files(tmp_path):
    paths = synth_files(str(tmp_path), n_taxa=20, sites=120, n_queries=48,
                        seed=3)
    a, b = _run_both(tmp_path, *paths, "GTR+G")
    assert len(a) == 48
    assert_same_placements(a, b)


@pytest.mark.parametrize("model,extra", [
    (GTR, ()),
    ("HKY+I{0.2}+G4", ("--chunk-size", "24")),
    (GTR, ("--baseball-heur", "--filter-acc-lwr", "0.99")),
    ("GTR+IC+G4", ()),
])
def test_cli_parity_evolved(tmp_path, model, extra):
    tree, ref, qry, _ = evolved_dataset(n_taxa=24, sites=160, n_queries=64,
                                        seed=7)
    tpath = str(tmp_path / "tree.nwk")
    with open(tpath, "w") as f:
        f.write(tree.plain_newick() + "\n")
    rpath, qpath = str(tmp_path / "ref.fasta"), str(tmp_path / "q.fasta")
    write_fasta(ref, rpath)
    write_fasta(qry, qpath)
    a, b = _run_both(tmp_path, tpath, rpath, qpath, model, extra)
    assert len(a) == 64
    assert_same_placements(a, b)


def _write_files(tmp_path, tree, ref, qry):
    tpath = str(tmp_path / "tree.nwk")
    with open(tpath, "w") as f:
        f.write(tree.plain_newick() + "\n")
    rpath, qpath = str(tmp_path / "ref.fasta"), str(tmp_path / "q.fasta")
    write_fasta(ref, rpath)
    write_fasta(qry, qpath)
    return tpath, rpath, qpath


@pytest.mark.parametrize("model,alphabet,extra", [
    (GTR, "ACGT", ("--raxml-blo",)),
    (GTR, "ACGT", ("--raxml-blo", "--no-heur")),
    ("BIN+G2{1.2}", "01", ()),
    ("GTGTR4{1.5/2.5/0.8/1.2/3.0/1.0}+FE+G4{0.8}", "ACGTMRSWYK", ())])
def test_cli_parity_twin_paths(tmp_path, model, alphabet, extra):
    """The paths that both packages run on their Newton twin, never on a
    kernel: ``--raxml-blo`` (independent branch optimization), binary
    (K = 2) and genotype (K = 10) models, on reads evolved under the
    model over its alphabet (the genotype one in pll_map_diploid10's state
    order)."""
    tree, ref, qry, _ = evolved_dataset(
        n_taxa=24, sites=160, n_queries=48, seed=7,
        model_str=None if alphabet == "ACGT" else model, alphabet=alphabet)
    paths = _write_files(tmp_path, tree, ref, qry)
    a, b = _run_both(tmp_path, *paths, model, extra)
    assert len(a) == 48
    assert_same_placements(a, b)


def test_cli_parity_opt_model(tmp_path):
    """``--opt-model`` from the generic GTR+G start through both CLIs.
    Two L-BFGS implementations reach the optimum by other paths, so the
    placements after them agree to the optimum's precision: the top edge
    up to ties on every query, and the best logl (which holds the rest of
    the tree's likelihood over the read's sites) within OPT_EPSILON, the
    optimizer's own stopping gap, of the JAX run's. To
    1e-6: the port's ``--opt-model`` run against the JAX CLI placing on
    the port's optimized tree and model (``optimize_model`` on the same
    files, written out at full precision)."""
    from epa_ng_tpu_torch.core.evaluate import OPT_EPSILON, optimize_model
    from epa_ng_tpu_torch.io import fasta as tfio
    tree, ref, qry, _ = evolved_dataset(n_taxa=16, sites=120, n_queries=32,
                                        seed=3)
    paths = _write_files(tmp_path, tree, ref, qry)
    a, b = _run_both(tmp_path, *paths, "GTR+G", ("--opt-model",))
    assert len(a) == len(b) == 32
    best = lambda rows: max(r["likelihood"] for r in rows)
    for q in a:
        ll = {r["edge_num"]: r["likelihood"] for r in a[q]}
        top = ll.get(b[q][0]["edge_num"], -np.inf)
        assert top >= best(a[q]) - 1e-5 * abs(best(a[q])), q
        assert abs(best(b[q]) - best(a[q])) <= OPT_EPSILON, q

    # the reference as the CLI reads it: premasked by the columns that
    # are gaps in every query (here the last one)
    ttree = Tree.from_file(paths[0])
    rinfo, qinfo = tfio.make_msa_info(paths[1]), tfio.make_msa_info(paths[2])
    tfio.MSAInfo.or_mask(rinfo, qinfo)
    tref = tfio.build_msa_from_file(paths[1], rinfo, True)
    model = Model.from_string("GTR+G")
    optimize_model(ttree, tref, model, device="cpu")
    num = lambda v: f"{float(v):.17g}"
    explicit = (f"GTR{{{'/'.join(num(r) for r in model.subst_rates)}}}"
                f"+FU{{{'/'.join(num(f) for f in model.base_freqs)}}}"
                f"+G4{{{num(model.alpha)}}}")
    opt_tree = str(tmp_path / "optimized.nwk")
    with open(opt_tree, "w") as f:
        f.write(ttree.plain_newick(precision=17) + "\n")
    jdir = str(tmp_path / "jax_on_port_optimum")
    assert jax_main(["--tree", opt_tree, "--ref-msa", paths[1], "--query",
                     paths[2], "--model", explicit, "--outdir", jdir,
                     "--redo"]) == 0
    assert_same_placements(
        _placements(os.path.join(jdir, "epa_result.jplace")), b)


@pytest.mark.parametrize("model", ["LG+G4{0.8}", "LG+I{0.2}+G4{0.8}"])
def test_cli_parity_protein(tmp_path, model):
    """Protein (K = 20) through both CLIs on LG-evolved reads; the +I model
    on the same data with 20% of its columns made invariant, so its
    invariant term bites."""
    from chip_smoke import with_invariant_sites
    from epa_ng_tpu.models import aa_matrices
    from epa_ng_tpu.utils.synth import AA
    tree, ref, qry, _ = evolved_dataset(n_taxa=24, sites=160, n_queries=48,
                                        seed=5, model_str="LG+G4{0.8}",
                                        alphabet=AA)
    if "+I" in model:
        ref, qry, _ = with_invariant_sites(
            ref, qry, aa_matrices.MATRICES["LG"][1], 0.2, seed=5,
            alphabet=AA)
    tpath = str(tmp_path / "tree.nwk")
    with open(tpath, "w") as f:
        f.write(tree.plain_newick() + "\n")
    rpath, qpath = str(tmp_path / "ref.fasta"), str(tmp_path / "q.fasta")
    write_fasta(ref, rpath)
    write_fasta(qry, qpath)
    a, b = _run_both(tmp_path, tpath, rpath, qpath, model)
    assert len(a) == 48
    assert_same_placements(a, b)


@pytest.fixture()
def mixture_both():
    """A four-component LG-derived matrix mixture registered in both
    packages' tables (the port keeps its own copy)."""
    from epa_ng_tpu.models import aa_matrices as jaa
    from epa_ng_tpu_torch.models import aa_matrices as taa
    from test_torch_blo_kernel_aa import mixture_components
    comps = mixture_components(4)
    for reg in (jaa, taa):
        reg.MIXTURES["TESTENGMIX"] = (comps, "gamma")
    yield "TESTENGMIX+G4{0.9}"
    for reg in (jaa, taa):
        reg.MIXTURES.pop("TESTENGMIX", None)


def _port_msa(msa):
    out = MSA()
    for s in msa:
        out.append(s.header, s.sequence)
    return out


def test_engine_parity_mixture(mixture_both):
    """A matrix mixture placed by both engines on the same random protein
    data, f64 on the CPU: the same edges, logl and lengths to 1e-6."""
    from epa_ng_tpu.utils.synth import AA, synth_dataset
    tree, ref, qry = synth_dataset(n_taxa=16, sites=96, n_queries=24,
                                   seed=13, alphabet=AA)
    jeng = JEngine(tree, ref, JModel.from_string(mixture_both), JOptions())
    teng = PlacementEngine(Tree.from_string(tree.plain_newick()),
                           _port_msa(ref), Model.from_string(mixture_both),
                           Options(), device="cpu")
    assert teng.consts.A.shape == (4, 20, 20)
    assert teng.ref_tree_logl == pytest.approx(jeng.ref_tree_logl, rel=1e-10)
    pa = jeng.place_chunk(qry)
    pb = teng.place_chunk(_port_msa(qry))
    assert len(pa) == len(pb) == 24
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(y.edge_nums, x.edge_nums)
        np.testing.assert_allclose(y.logls, x.logls, rtol=1e-6)
        np.testing.assert_allclose(y.pendant_lengths, x.pendant_lengths,
                                   rtol=1e-6)
        np.testing.assert_allclose(y.distal_lengths, x.distal_lengths,
                                   rtol=1e-6)


def test_state_from_numpy_carries_a_mixture(mixture_both):
    """The JAX engine's mixture state crosses to the port whole: per-rate
    A/Ainv [R, K, K], eigenvalues and frequencies [R, K], and the BLO
    store, whose kernel tables are then per-rate rows."""
    from epa_ng_tpu.utils.synth import AA, synth_dataset
    from epa_ng_tpu_torch.core.engine import state_from_numpy
    from epa_ng_tpu_torch.ops import blo_kernel as bk
    tree, ref, _ = synth_dataset(n_taxa=10, sites=48, n_queries=4, seed=3,
                                 alphabet=AA)
    jeng = JEngine(tree, ref, JModel.from_string(mixture_both), JOptions())
    consts, blo, table = state_from_numpy(jeng.consts, jeng.blo,
                                          jeng.lookup_table, device="cpu")
    assert consts.A.shape == consts.Ainv.shape == (4, 20, 20)
    assert consts.eigenvals.shape == consts.freqs.shape == (4, 20)
    for name in consts._fields:
        np.testing.assert_array_equal(getattr(consts, name).numpy(),
                                      np.asarray(getattr(jeng.consts, name)))
    assert blo.tU.shape[1] == 80 and table.dtype == torch.float64
    x_rk, wA, A, piA = bk._kernel_scalars(consts, torch.float64)
    assert A.shape == piA.shape == wA.shape == (80, 20)
    np.testing.assert_array_equal(A.numpy(),
                                  np.asarray(jeng.consts.A).reshape(80, 20))


def test_from_precomputed_matches_jax_engine():
    """A port engine fed the JAX engine's edge tensors (numpy) places like
    the JAX engine."""
    tree, ref, qry, _ = evolved_dataset(n_taxa=20, sites=96, n_queries=32,
                                        seed=11)
    jeng = JEngine(tree, ref, JModel.from_string(GTR), JOptions())
    eig = jeigen.decompose(JModel.from_string(GTR))
    edges, _ = jclv.build_reference_state(
        tree, eig, jclv.tip_clv_matrix(tree, ref, 4))
    np_edges = type("E", (), {f: np.asarray(getattr(edges, f))
                              for f in ("U", "V", "lsU", "lsV", "lengths")})
    ttree = Tree.from_string(tree.plain_newick())
    teng = PlacementEngine.from_precomputed(
        ttree, Model.from_string(GTR), Options(), np_edges, 96, device="cpu")
    assert teng.ref_tree_logl == pytest.approx(jeng.ref_tree_logl, rel=1e-10)
    tq = MSA()
    for s in qry:
        tq.append(s.header, s.sequence)
    pa = jeng.place_chunk(qry)
    pb = teng.place_chunk(tq)
    assert len(pa) == len(pb) == 32
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(y.edge_nums, x.edge_nums)
        np.testing.assert_allclose(y.logls, x.logls, rtol=1e-6)
        np.testing.assert_allclose(y.lwrs, x.lwrs, rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(y.pendant_lengths, x.pendant_lengths,
                                   rtol=1e-6)
        np.testing.assert_allclose(y.distal_lengths, x.distal_lengths,
                                   rtol=1e-6)


@pytest.mark.parametrize("flag", [
    (["--mesh", "3x1"], "Bad --mesh '3x1': dp must be a power of two"),
    (["--mesh", "bad"], "Bad --mesh 'bad': want DPxEP, e.g. 4x2"),
    (["--memsave", "--mesh", "2x1"],
     "--mesh and --memsave are mutually exclusive"),
    (["--distributed", "127.0.0.1:1,two,0"],
     "Error: bad --distributed spec '127.0.0.1:1,two,0' (want "
     "coordinator:port,num_procs,process_id)"),
    (["--mesh", "0x2"], "Bad --mesh '0x2': dp and ep must be >= 1")])
def test_unported_flags_exit_nonzero(tmp_path, flag, capsys):
    """The multi-device and multi-process flags refuse what the JAX CLI
    refuses, with its messages, before any state is built (no tree is given here: a run past the checks would fail on
    that instead). A bad --distributed spec exits as the JAX CLI does,
    through SystemExit."""
    argv, message = flag
    try:
        rc = torch_main(["--outdir", str(tmp_path), "--device", "cpu",
                         *argv])
        said = capsys.readouterr().out
    except SystemExit as e:
        rc, said = 1, str(e)
    assert rc == 1
    assert message in said


@pytest.mark.parametrize("model,refused", [
    ("LG+G4", False), ("LG+I+G4", False), ("BIN+G4", False),
    ("GTGTR4+G4", False), ("HKY+I{0.2}+G4", False), ("GTR+IC+G4", False),
    ("LG+IC+G4", False), ("mixture", False), ("GTR+G16", False),
    ("GTR+I+R10", False), ("LG+G16", False), ("LG+G44", False),
    ("GTR+G313", False)])
def test_cuda_refuses_unported_models(model, refused, mixture_both):
    """On the card DNA and protein run, single-matrix with or without +I
    (fixed or empirical p-inv), and protein matrix mixtures, up to the
    kernel's rate cap (16 gamma and 10 free rates run, and 44 at 20
    states); past it (313 at 4 states) the torch twin runs, as the JAX
    package runs its XLA twin there, and so do binary and genotype models
    and ``--raxml-blo``: no model the JAX package places is refused. The
    check needs no card (it refuses before any tensor is made)."""
    model = mixture_both if model == "mixture" else model
    if refused:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            _check_device_model(torch.device("cuda"),
                                Model.from_string(model))
    else:
        _check_device_model(torch.device("cuda"), Model.from_string(model))
    _check_device_model(torch.device("cpu"), Model.from_string(model))
    _check_device_model(torch.device("cuda"), Model.from_string(GTR))
    _check_device_model(torch.device("cuda"), Model.from_string(model),
                        sliding=False)


def test_pallas_on_needs_the_card():
    tree, ref, qry, _ = evolved_dataset(n_taxa=12, sites=64, n_queries=8,
                                        seed=1)
    ttree = Tree.from_string(tree.plain_newick())
    tref = MSA()
    for s in ref:
        tref.append(s.header, s.sequence)
    eng = PlacementEngine(ttree, tref, Model.from_string(GTR),
                          Options(pallas="on"), device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        eng._use_kernel()


@pytest.mark.parametrize("device,dtype,pallas,rates,sliding,expect,states", [
    ("cuda", torch.float32, "auto", 4, True, True, 4),
    ("cuda", torch.float32, "on", 1, True, True, 4),
    ("cuda", torch.float32, "off", 4, True, False, 4),
    ("cuda", torch.float64, "auto", 4, True, False, 4),
    ("cpu", torch.float32, "auto", 4, True, False, 4),
    ("cuda", torch.float32, "auto", 9, True, True, 4),
    ("cuda", torch.float32, "auto", 313, True, False, 4),
    ("cuda", torch.float32, "auto", 4, False, False, 4),
    ("cpu", torch.float32, "on", 4, True, ValueError, 4),
    ("cuda", torch.float32, "auto", 4, True, True, 20),
    ("cuda", torch.float32, "auto", 4, True, True, "mixture"),
    ("cuda", torch.float32, "auto", 9, True, True, 20),
    ("cuda", torch.float32, "auto", 44, True, True, 20),
    ("cuda", torch.float32, "auto", 28, True, True, "mixture"),
    ("cpu", torch.float32, "auto", 4, True, False, "mixture"),
    ("cuda", torch.float32, "auto", 4, True, False, 2),
    ("cuda", torch.float32, "auto", 4, True, False, 10),
    ("cuda", torch.float32, "auto", 313, False, False, 4),
    ("cuda", torch.float32, "on", 4, True, ValueError, 2)])
def test_kernel_routing_rule(device, dtype, pallas, rates, sliding, expect,
                             states):
    """On a cuda device in f32 the Newton stage takes the kernel at every
    window width, or raises "not yet ported"; ``--pallas off``, f64 and the
    CPU take the torch twin, and so do what the JAX package runs on its
    XLA twin: 2 and 10 states, non-sliding BLO (at any rate count) and
    rate counts past the kernel's cap, where ``--pallas on`` is refused.
    The kernel takes 4 and 20 states and 20-state matrix mixtures, 9 rate
    categories among them, up to its cap (312 at 4 states, 64 at 20, a
    single matrix or a mixture). The rule needs no card: it reads the
    engine's device, dtype, options and eigen constants."""
    from types import SimpleNamespace

    from epa_ng_tpu_torch.ops import newton as tnewton
    K = 20 if states == "mixture" else states
    lead = (rates,) if states == "mixture" else ()
    consts = tnewton.EigConsts(
        eigenvals=torch.zeros(*lead, K, dtype=dtype),
        A=torch.eye(K, dtype=dtype).expand(*lead, K, K),
        Ainv=torch.eye(K, dtype=dtype).expand(*lead, K, K),
        freqs=torch.full((*lead, K), 1.0 / K),
        rates=torch.ones(rates), weights=torch.ones(rates) / rates,
        pinv=0.0)
    eng = SimpleNamespace(
        device=torch.device(device), dtype=dtype, consts=consts,
        options=Options(pallas=pallas, sliding_blo=sliding))
    if isinstance(expect, bool):
        assert PlacementEngine._use_kernel(eng) is expect
    else:
        with pytest.raises(expect, match="not yet ported|CUDA"):
            PlacementEngine._use_kernel(eng)


@functools.lru_cache(maxsize=None)
def _routing_twin(data):
    """The routing cases' data and the f32 twin engine on it (the evolved
    cases share one): (model, tree, reference, queries, engine)."""
    model = GTR
    if data == "evolved LG+G4":
        from epa_ng_tpu.utils.synth import AA
        model = "LG+G4{0.8}"
        tree, ref, qry, _ = evolved_dataset(n_taxa=24, sites=160,
                                            n_queries=48, seed=3,
                                            model_str=model, alphabet=AA)
    elif data == "evolved":
        tree, ref, qry, _ = evolved_dataset(n_taxa=40, sites=160,
                                            n_queries=96, seed=3)
    else:
        from epa_ng_tpu.utils.synth import synth_dataset
        tree, ref, qry = synth_dataset(n_taxa=40, sites=160, n_queries=96,
                                       seed=3)
    ttree = Tree.from_string(tree.plain_newick())
    tref, tq = _port_msa(ref), _port_msa(qry)
    twin = PlacementEngine(ttree, tref, Model.from_string(model),
                           Options(compute_dtype="f32", chunk_size=96),
                           device="cpu")
    return model, ttree, tref, tq, twin


@functools.lru_cache(maxsize=None)
def _routing_twin_exact(data):
    """The twin's exact placements of the routing case (no fused budget)."""
    *_, tq, twin = _routing_twin(data)
    return twin._place_chunk_exact(twin.encode_msa(tq), 0)


@pytest.mark.parametrize("data,topk,route", [
    ("evolved", 16, None), ("evolved", 10, "_redo_wide"),
    ("random", 16, "_escalations"), ("evolved LG+G4", 16, None)])
def test_engine_kernel_routing_on_cpu(monkeypatch, data, topk, route):
    """The engine's kernel routing (fused step, wide redo, escalation
    ladder, exact ``_thorough`` slabs) driven on CPU tensors, where the
    kernel's wrapper takes its plain version; against the twin routing of
    the same f32 engine. A smaller fused budget (evolved, 10) sends a few
    saturated queries through the wide redo; random queries have flat
    posteriors and escalate the whole chunk. The two Newton forms round
    differently in f32, so the best logl agrees to 1e-5 relative and a top
    edge up to ties (the twin scores it within 1e-5 relative of its
    best). ``evolved LG+G4`` runs the same routing at K = 20 on
    LG-evolved reads."""
    model, ttree, tref, tq, twin = _routing_twin(data)
    twin.options.fused_topk = topk
    ref_pq = twin.place_chunk(tq)
    ref_exact = _routing_twin_exact(data)
    opts = Options(compute_dtype="f32", chunk_size=96, fused_topk=topk)

    from epa_ng_tpu_torch.ops import blo_kernel
    kern = PlacementEngine(ttree, tref, Model.from_string(model), opts,
                           device="cpu")
    monkeypatch.setattr(kern, "_use_kernel", lambda: (
        blo_kernel.blo_unsupported(kern.consts) is None))
    redos = []
    redo_wide = kern._redo_wide
    monkeypatch.setattr(kern, "_redo_wide", lambda *a, **k: (
        redos.append(1), redo_wide(*a, **k))[1])
    got_pq = kern.place_chunk(tq)
    got_exact = kern._place_chunk_exact(kern.encode_msa(tq), 0)
    if route == "_redo_wide":
        assert redos
    elif route == "_escalations":
        assert kern._escalations > 0
    for a, b in ((ref_pq, got_pq), (ref_exact, got_exact)):
        assert [p.seq_id for p in a] == [p.seq_id for p in b]
        agree = []
        for x, y in zip(a, b):
            assert y.logls[0] == pytest.approx(x.logls[0], rel=1e-5)
            ll = dict(zip(x.edge_nums.tolist(), x.logls.tolist()))
            top = ll.get(int(y.edge_nums[0]), -np.inf)
            agree.append(top >= x.logls[0] - 1e-5 * abs(x.logls[0]))
        if data != "random":
            # random queries tie across more edges than filter_max keeps,
            # so their top edges are compared by logl only
            assert np.mean(agree) >= 0.99


def test_redo_splice_keeps_input_order():
    """Queries redone after the fused step are spliced back in input order
    even when several redone queries are neighbours in the input (they
    share one insertion offset). On this chunk queries 6, 7 and 8 saturate
    a budget of 10 and are redone; each must carry its own placements, as
    when placed alone. (The JAX package's splice sorts by offset alone and
    returns Q6's placements under Q8 and back here.)"""
    from epa_ng_tpu_torch.utils.synth import evolved_dataset as t_evolved
    tree, ref, qry, _ = t_evolved(n_taxa=40, sites=160, n_queries=96, seed=3)
    eng = PlacementEngine(tree, ref, Model.from_string(GTR),
                          Options(chunk_size=96, fused_topk=10), device="cpu")
    chunk = eng.place_chunk(qry)
    seqs = list(qry)
    for q in (6, 7, 8):
        alone = MSA()
        alone.append(seqs[q].header, seqs[q].sequence)
        single = eng._place_chunk_exact(eng.encode_msa(alone), 0)[0]
        assert chunk[q].headers == [seqs[q].header]
        np.testing.assert_array_equal(chunk[q].edge_nums[:1],
                                      single.edge_nums[:1])
        assert chunk[q].logls[0] == pytest.approx(single.logls[0], rel=1e-9)

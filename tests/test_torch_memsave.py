"""Port parity of ``core/memsave.py`` (``--memsave``), f64 on the CPU: the
port's ``OutOfCoreEngine`` against the JAX package's on the same data, at
every budget tier. Every query's edge list must be identical; logl, LWR
and lengths agree within 1e-6 relative (``test_torch_engine``'s
``assert_same_placements`` tolerance).

On the CPU the port's engine places with the plain paths (the torch Newton
twin), so the streamed misses take the twin here; on the card they take
the kernel's per-pair shape (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 8 hold that route to the resident engine).
"""

import os

import numpy as np
import pytest
import torch

from epa_ng_tpu.cli import main as jax_main
from epa_ng_tpu.core.memsave import OutOfCoreEngine as JOutOfCoreEngine
from epa_ng_tpu.models import Model as JModel
from epa_ng_tpu.utils.options import Options as JOptions
from epa_ng_tpu.utils.synth import synth_dataset, synth_files

from epa_ng_tpu_torch.cli import main as torch_main
from epa_ng_tpu_torch.core import memsave
from epa_ng_tpu_torch.core.engine import PlacementEngine
from epa_ng_tpu_torch.core.memsave import OutOfCoreEngine
from epa_ng_tpu_torch.models import Model
from epa_ng_tpu_torch.tree import Tree
from epa_ng_tpu_torch.utils.options import Options
from test_torch_engine import _placements, _port_msa, assert_same_placements

# one intra-op thread per test process: the suite runs in parallel
# workers, and a thread per core in each of them oversubscribes the
# CPU and slows the small tensor ops here by orders of magnitude
torch.set_num_threads(1)

GTR = "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G4{0.6}"
# caches one preplacement block of five and 24 of the 77 edges at
# EDGE_BLOCK = 16 (the store is 6.16 MB): hits and misses both run
PARTIAL_GB = 2e-3


@pytest.fixture(scope="module")
def data():
    """The JAX test's data (tests/test_memsave.py) in both packages'
    types, and the JAX engine's budget-0 (pure streaming) placements."""
    tree, ref, qry = synth_dataset(n_taxa=40, sites=200, n_queries=24,
                                   seed=21)
    jeng = JOutOfCoreEngine(tree, ref, JModel.from_string(GTR),
                            JOptions(blo_block=64, memsave=True,
                                     memsave_budget_gb=0.0))
    port = (Tree.from_string(tree.plain_newick()), _port_msa(ref),
            _port_msa(qry))
    return (tree, ref, qry), port, jeng.place_chunk(qry)


def _engine(port, gb, **kw):
    tree, ref, _ = port
    return OutOfCoreEngine(tree, ref, Model.from_string(GTR),
                           Options(blo_block=64, memsave=True,
                                   memsave_budget_gb=gb, **kw),
                           device="cpu")


def assert_same_pqueries(want, got):
    assert [p.seq_id for p in got] == [p.seq_id for p in want]
    for x, y in zip(want, got):
        np.testing.assert_array_equal(y.edge_nums, x.edge_nums)
        for f in ("logls", "lwrs", "pendant_lengths", "distal_lengths"):
            np.testing.assert_allclose(getattr(y, f), getattr(x, f),
                                       rtol=1e-6, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("tier", ["stream", "partial", "cover"])
def test_memsave_tiers_match_jax(monkeypatch, data, tier):
    """Pure streaming, the cached prefix beside streamed misses, and a
    covering budget (the fused device-resident path) all give the JAX
    engine's placements; the device cache stays within the budget."""
    _, port, want = data
    qry = port[2]
    if tier == "partial":
        # several preplacement blocks, so cached and streamed ones mix
        monkeypatch.setattr(memsave, "EDGE_BLOCK", 16)
    gb = {"stream": 0.0, "partial": PARTIAL_GB, "cover": 100.0}[tier]
    eng = _engine(port, gb)
    assert eng.edges is None and isinstance(eng._tU_h, torch.Tensor)
    assert (eng._blo is None) == (tier != "cover")
    if tier == "cover":
        assert eng._full_cover and eng._blo_cache_edges == eng.num_edges
        handle = eng.place_encoded_async(eng.encode_msa(qry))
        assert handle[0] == "fused"
        got = eng.finalize_chunk(handle).to_pqueries()
    else:
        got = eng.place_chunk(qry)
        assert eng.device_cached_bytes() <= gb * 1e9
    assert_same_pqueries(want, got)
    st = eng.memsave_stats()
    if tier == "stream":
        assert eng.device_cached_bytes() == 0
        assert st["memsave_hit_pairs"] == 0
        assert st["memsave_streamed_pairs"] > 0
    elif tier == "partial":
        assert 0 < eng._pre_cache_nblocks < -(-eng.num_edges // 16)
        assert 0 < st["memsave_cached_edges"] < eng.num_edges
        assert st["memsave_hit_pairs"] > 0
        assert st["memsave_streamed_pairs"] > 0
    # the twin ran (the CPU has no kernel); nothing was uploaded and no
    # staging slot holds device memory
    assert eng.newton_work.totals()["twin_launches"] > 0
    assert st["h2d_mb"] == 0.0 and st["memsave_ring_mb"] == 0.0
    assert st["memsave_host_mb"] == eng.host_resident_bytes() / 1e6


@pytest.mark.parametrize("kw", [{"prescoring": False},
                                {"premasking": False}],
                         ids=["no_heur", "no_premask"])
def test_memsave_no_heur_and_no_premask(data, kw):
    (tree, ref, qry), port, _ = data
    jeng = JOutOfCoreEngine(tree, ref, JModel.from_string(GTR),
                            JOptions(blo_block=64, memsave=True,
                                     memsave_budget_gb=0.0, **kw))
    eng = _engine(port, 0.0, **kw)
    assert_same_pqueries(jeng.place_chunk(qry), eng.place_chunk(port[2]))


def test_memsave_streamed_preplace_matches(monkeypatch, data):
    """The streamed preplacement, block by block with a padded last block,
    gives the resident engine's scores."""
    _, port, _ = data
    monkeypatch.setattr(memsave, "EDGE_BLOCK", 16)
    tree, ref, qry = port
    res = PlacementEngine(tree, ref, Model.from_string(GTR), Options(),
                          device="cpu")
    ec = res.encode_msa(qry)
    want = res.preplace(ec.codes, ec.ranges)
    for gb in (0.0, PARTIAL_GB):
        got = _engine(port, gb).preplace(ec.codes, ec.ranges)
        np.testing.assert_allclose(got, want, rtol=1e-10)


def test_memsave_pallas_on_rejected_before_build(monkeypatch, data):
    _, port, _ = data

    def built(*a, **k):
        raise AssertionError("the reference state was built")

    monkeypatch.setattr(PlacementEngine, "__init__", built)
    with pytest.raises(ValueError, match="pallas"):
        _engine(port, 0.0, pallas="on")


def test_memsave_cli_matches_jax(tmp_path):
    """``--memsave --memsave-budget 0`` through both CLIs on the same
    files; the port's run reports its streamed pairs."""
    from epa_ng_tpu_torch import cli
    paths = synth_files(str(tmp_path), n_taxa=20, sites=120, n_queries=32,
                        seed=3)
    common = ["--tree", paths[0], "--ref-msa", paths[1], "--query",
              paths[2], "--model", GTR, "--redo", "--memsave",
              "--memsave-budget", "0"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_main(common + ["--outdir", jdir]) == 0
    assert torch_main(common + ["--outdir", tdir, "--device", "cpu"]) == 0
    st = cli.LAST_RUN_STATS
    assert st["memsave_cached_edges"] == 0
    assert st["memsave_streamed_pairs"] > 0 and st["memsave_hit_pairs"] == 0
    a = _placements(os.path.join(jdir, "epa_result.jplace"))
    b = _placements(os.path.join(tdir, "epa_result.jplace"))
    assert len(a) == 32
    assert_same_placements(a, b)


def test_memsave_binary_round_trip(tmp_path, data):
    """``--dump-binary`` then ``-b --memsave``: the store placed out of
    core gives the direct --memsave run of the same files."""
    from epa_ng_tpu.utils.synth import write_fasta
    (tree, ref, qry), _, _ = data
    tpath = str(tmp_path / "tree.nwk")
    with open(tpath, "w") as f:
        f.write(tree.plain_newick() + "\n")
    rpath, qpath = str(tmp_path / "ref.fasta"), str(tmp_path / "q.fasta")
    write_fasta(ref, rpath)
    write_fasta(qry, qpath)
    run = lambda argv, out: torch_main(
        argv + ["--outdir", str(tmp_path / out), "--redo", "--device",
                "cpu"])
    assert run(["--tree", tpath, "--ref-msa", rpath, "--model", GTR,
                "--dump-binary"], "dump") == 0
    store = str(tmp_path / "dump" / "epa_binary_file.npz")
    flags = ["--query", qpath, "--memsave", "--memsave-budget", "0",
             "--no-pre-mask"]
    assert run(["-b", store] + flags, "b") == 0
    assert run(["--tree", tpath, "--ref-msa", rpath, "--model", GTR]
               + flags, "direct") == 0
    assert_same_placements(
        _placements(str(tmp_path / "direct" / "epa_result.jplace")),
        _placements(str(tmp_path / "b" / "epa_result.jplace")))


def test_memsave_dump_keeps_host_edges(data):
    """Under --dump-binary the out-of-core engine keeps the host-built edge
    tensors for the dump and builds no stores."""
    _, (tree, ref, _), _ = data
    eng = OutOfCoreEngine(tree, ref, Model.from_string(GTR),
                          Options(memsave=True, dump_binary_mode=True),
                          device="cpu")
    assert eng.edges is not None and eng.edges.U.device.type == "cpu"
    assert not hasattr(eng, "_tU_h")


def test_memsave_options_are_the_jax_ones():
    """The budget rules' constants are the JAX package's."""
    from epa_ng_tpu.core import memsave as jmemsave
    for name in ("EDGE_BLOCK", "PRE_PIPELINE_DEPTH", "SLAB_PIPELINE_DEPTH",
                 "AUTO_BUDGET_FRACTION", "AUTO_BUDGET_FALLBACK"):
        assert getattr(memsave, name) == getattr(jmemsave, name), name


# protein models past the DNA cell: K = 20 with one matrix, a four-component
# LG-derived matrix mixture, and 16 rate categories (on the card: the K = 20
# per-pair shape, the mixture's and the cluster's)
AA_MODELS = {"lg": "LG+G4{0.8}", "mixture": "TESTMSMIX+G4{0.9}",
             "lg_g16": "LG+G16{0.8}"}


@pytest.fixture(scope="module")
def aa_data():
    """24 random protein taxa x 96 sites and 12 reads in both packages'
    types, the four-component mixture registered in both packages' tables,
    the JAX engine's budget-0 placements per model, made on first use,
    and the port's host store bytes per model, kept by the first run."""
    from epa_ng_tpu.models import aa_matrices as jaa
    from epa_ng_tpu.utils.synth import AA
    from epa_ng_tpu_torch.models import aa_matrices as taa
    from test_torch_blo_kernel_aa import mixture_components
    comps = mixture_components(4)
    for reg in (jaa, taa):
        reg.MIXTURES["TESTMSMIX"] = (comps, "gamma")
    tree, ref, qry = synth_dataset(n_taxa=24, sites=96, n_queries=12,
                                   seed=21, alphabet=AA)
    port = (Tree.from_string(tree.plain_newick()), _port_msa(ref),
            _port_msa(qry))
    want, host_bytes = {}, {}

    def jax_placements(model):
        if model not in want:
            jeng = JOutOfCoreEngine(tree, ref, JModel.from_string(model),
                                    JOptions(blo_block=64, memsave=True,
                                             memsave_budget_gb=0.0))
            want[model] = jeng.place_chunk(qry)
        return want[model]

    yield port, jax_placements, host_bytes
    for reg in (jaa, taa):
        reg.MIXTURES.pop("TESTMSMIX", None)


@pytest.mark.parametrize("tier", ["stream", "partial"])
@pytest.mark.parametrize("case", sorted(AA_MODELS))
def test_memsave_aa_tiers_match_jax(monkeypatch, aa_data, case, tier):
    """Protein under --memsave, f64: pure streaming and the cached prefix
    beside streamed misses (half the host store, in blocks of 16 edges)
    give the JAX engine's budget-0 placements, for one matrix (LG+G4), a
    matrix mixture and 16 rate categories."""
    port, jax_placements, host_bytes = aa_data
    model = AA_MODELS[case]
    engine = lambda gb: OutOfCoreEngine(
        port[0], port[1], Model.from_string(model),
        Options(blo_block=64, memsave=True, memsave_budget_gb=gb),
        device="cpu")
    if tier == "stream" or model not in host_bytes:
        eng = engine(0.0)
        host_bytes[model] = eng.host_resident_bytes()
    if tier == "partial":
        monkeypatch.setattr(memsave, "EDGE_BLOCK", 16)
        eng = engine(host_bytes[model] / 2 / 1e9)
    got = eng.place_chunk(port[2])
    assert_same_pqueries(jax_placements(model), got)
    st = eng.memsave_stats()
    assert st["memsave_streamed_pairs"] > 0
    if tier == "stream":
        assert st["memsave_cached_edges"] == 0 and st["memsave_hit_pairs"] == 0
    else:
        assert 0 < st["memsave_cached_edges"] < eng.num_edges
        assert st["memsave_hit_pairs"] > 0
    assert eng.newton_work.totals()["twin_launches"] > 0

"""Port parity of the multi-device half of ``parallel/mesh.py`` and of
``PlacementEngine.attach_mesh`` (``--mesh``), f64 on the CPU: the port's
sharded step on a mesh of CPU shards (``["cpu"] * 8``, a placement map in
which every shard is the CPU) against the JAX package's on the 8 virtual
host devices that tests/conftest.py sets up, and the attached engine
against the port's plain engine.

Tolerances are the fused step's parity tests': logl and LWR within 1e-8
absolute, pendant and distal lengths within 1e-7, top edges equal. The
32-taxon tree has 61 edges, an odd count, so ep = 2 and ep = 4 pad the
edge axis (1 and 3 pad edges).

On the card every shard runs the CUDA kernel; ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 9 hold that route to the resident engine.
"""

import numpy as np
import pytest
import torch

from epa_ng_tpu.core.engine import PlacementEngine as JEngine
from epa_ng_tpu.io.fasta import MSA as JMSA, Sequence
from epa_ng_tpu.models import Model as JModel
from epa_ng_tpu.parallel import mesh as jmesh
from epa_ng_tpu.utils.options import Options as JOptions
from epa_ng_tpu.utils.synth import synth_dataset, synth_files

from chip_smoke import with_invariant_sites
from epa_ng_tpu_torch.cli import main as torch_main
from epa_ng_tpu_torch.core.engine import PlacementEngine
from epa_ng_tpu_torch.models import Model
from epa_ng_tpu_torch.parallel import mesh, scaling
from epa_ng_tpu_torch.tree import Tree
from epa_ng_tpu_torch.utils.options import Options
from test_torch_engine import _placements, _port_msa, assert_same_placements

# one intra-op thread per test process: the suite runs in parallel
# workers, and a thread per core in each of them oversubscribes the
# CPU and slows the small tensor ops here by orders of magnitude
torch.set_num_threads(1)

GTR = "GTR{1.3/2.2/0.9/1.4/3.8/1}+FU{0.26/0.24/0.25/0.25}+G4{0.9}"
PINV = "GTR{1.3/2.2/0.9/1.4/3.8/1}+FU{0.26/0.24/0.25/0.25}+I{0.2}+G4{0.9}"
CPUS = ["cpu"] * 8
LOGL_TOL, LEN_TOL = 1e-8, 1e-7


def _port_engine(tree, ref, model, **opts):
    """The port's engine on the JAX package's data, f64 on the CPU."""
    return PlacementEngine(Tree.from_string(tree.plain_newick()),
                           _port_msa(ref), Model.from_string(model),
                           Options(compute_dtype="f64", **opts),
                           device="cpu")


def _engines(tree, ref, model, **opts):
    """The JAX engine and the port's on the same data and options, f64."""
    jeng = JEngine(tree, ref, JModel.from_string(model),
                   JOptions(compute_dtype="f64", **opts))
    return jeng, _port_engine(tree, ref, model, **opts)


def _batch(jeng, teng, qry):
    """One chunk's (codes, begins, spans, tQ, invq) in both packages'
    types, from the same encoded codes."""
    ec = jeng.encode_msa(qry)
    tQ, invq = jeng._query_tensors_codes(ec.codes)
    jargs = tuple(np.asarray(x) for x in (ec.codes, ec.ranges[:, 0],
                                          ec.ranges[:, 1], tQ, invq))
    ttQ, tinvq = teng._query_tensors_codes(ec.codes)
    targs = tuple(torch.as_tensor(x) for x in jargs[:3]) + (ttQ, tinvq)
    return ec, jargs, targs


@pytest.fixture(scope="module")
def step_data():
    tree, ref, qry = synth_dataset(n_taxa=32, sites=128, n_queries=16,
                                   seed=9)
    jeng, teng = _engines(tree, ref, GTR, blo_block=64)
    assert teng.num_edges == 61
    return (jeng, teng) + _batch(jeng, teng, qry)


def _assert_same_step(a, b):
    """The 7 outputs of the unfiltered step (edges, logl, lwr, pendant,
    distal, valid, computed), JAX ``a`` against the port's ``b``."""
    names = ("edges", "logl", "lwr", "pendant", "distal", "valid",
             "computed")
    for name, x, y in zip(names, a, b):
        x, y = np.asarray(x), y.numpy()
        tol = {"logl": LOGL_TOL, "lwr": LOGL_TOL, "pendant": LEN_TOL,
               "distal": LEN_TOL}.get(name)
        if tol is None:
            np.testing.assert_array_equal(y, x, err_msg=name)
        else:
            np.testing.assert_allclose(y, x, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("n_dp,n_ep", [(8, 1), (4, 2), (2, 4)])
def test_sharded_step_matches_jax(step_data, n_dp, n_ep):
    """The sharded step on a dp x ep mesh against JAX's shard_map'd step
    on the same mesh; the pads never reach the output."""
    jeng, teng, _, jargs, targs = step_data
    want = jmesh.ShardedPlacement(jeng, jmesh.make_mesh(n_dp, n_ep),
                                  topk=4).step(*jargs)
    sp = mesh.ShardedPlacement(teng, mesh.make_mesh(n_dp, n_ep, CPUS),
                               topk=4)
    got = sp.step(*targs)
    _assert_same_step(want, got)
    assert sp.pad == (-61) % n_ep
    assert int(got[0].max()) < teng.num_edges
    # each distinct (device, ep slice) holds its slice once
    shards = sp.shard_nbytes()
    assert len(shards) == n_ep
    assert sum(s["edges"] for s in shards) == 61 + sp.pad


def test_preplace_select_matches_jax(step_data):
    jeng, teng, _, jargs, targs = step_data
    for topk in (4, 16):
        want = jmesh.preplace_select(jeng.lookup_table, *jargs[:3], 0.99999,
                                     topk=topk)
        got = mesh.preplace_select(teng.lookup_table, *targs[:3], 0.99999,
                                   topk)
        for x, y in zip(want, got):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def test_sharded_preplace_matches_jax():
    """The mesh engine's preplacement scores (the exact path's entry) on
    an odd batch, which the dp axis pads: JAX's mesh engine and the port's
    plain engine give the same [Q, E] scores."""
    tree, ref, qry = synth_dataset(n_taxa=32, sites=128, n_queries=15,
                                   seed=9)
    jeng, teng = _engines(tree, ref, GTR)
    plain = _port_engine(tree, ref, GTR)
    jeng.attach_mesh(jmesh.make_mesh(2, 4))
    teng.attach_mesh(mesh.make_mesh(2, 4, CPUS))
    ec = jeng.encode_msa(qry)
    want = jeng.preplace(ec.codes, ec.ranges)
    got = teng.preplace(ec.codes, ec.ranges)
    assert got.shape == (15, 61)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(got, plain.preplace(ec.codes, ec.ranges),
                               rtol=1e-12, atol=1e-9)


def _flat_read_data(n_taxa=32, sites=128, n_queries=30, alphabet="ACGT"):
    """JAX test_sharding's data: 30 evolved reads and 4 barely informative
    ones (flat posteriors, so the redo paths have work); over another
    ``alphabet`` (protein) at another size, random reads in their place."""
    tree, ref, qry = synth_dataset(n_taxa=n_taxa, sites=sites,
                                   n_queries=n_queries, seed=21,
                                   alphabet=alphabet)
    rng = np.random.default_rng(5)
    for i in range(4):
        start = int(rng.integers(0, sites - 8))
        s = ["-"] * sites
        for j in range(start, start + 8):
            s[j] = alphabet[rng.integers(0, len(alphabet))]
        qry.sequences.append(Sequence([f"F{i}"], "".join(s)))
    return tree, ref, JMSA(sequences=qry.sequences, num_sites=qry.num_sites)


def assert_same_pqueries(want, got, tol=LOGL_TOL):
    assert [p.seq_id for p in got] == [p.seq_id for p in want]
    for x, y in zip(want, got):
        np.testing.assert_array_equal(y.edge_nums, x.edge_nums)
        for f, t in (("logls", tol), ("lwrs", tol),
                     ("pendant_lengths", LEN_TOL),
                     ("distal_lengths", LEN_TOL)):
            np.testing.assert_allclose(getattr(y, f), getattr(x, f),
                                       rtol=0, atol=t, err_msg=f)


@pytest.fixture()
def mesh_mixture():
    """A four-component LG-derived matrix mixture in both packages'
    tables."""
    from epa_ng_tpu.models import aa_matrices as jaa
    from epa_ng_tpu_torch.models import aa_matrices as taa
    from test_torch_blo_kernel_aa import mixture_components
    comps = mixture_components(4)
    for reg in (jaa, taa):
        reg.MIXTURES["TESTMESHMIX"] = (comps, "gamma")
    yield
    for reg in (jaa, taa):
        reg.MIXTURES.pop("TESTMESHMIX", None)


LG = "LG+G4{0.8}"
MIX = "TESTMESHMIX+G4{0.9}"


@pytest.mark.parametrize("model", [GTR, PINV, LG, MIX],
                         ids=["gtr", "pinv", "lg", "mixture"])
def test_attach_mesh_matches_plain_and_jax(model, mesh_mixture):
    """An engine with a 4x2 mesh attached places like the plain engine,
    and its fused dispatch (the sharded step with the on-device filter),
    wide redo and exact redo (preplace on the shards, then the
    host-window Newton) match JAX's attached engine; under +I too, and
    for protein (24 random taxa x 96 sites, 12 reads and 4 barely
    informative ones) under LG+G4 and a matrix mixture (on the card: the
    K = 20 and the mixture's blocked shape on the shards, their per-pair
    shape in the exact redo)."""
    protein = model in (LG, MIX)
    if protein:
        from epa_ng_tpu.utils.synth import AA
        tree, ref, qry = _flat_read_data(24, 96, 12, AA)
    else:
        tree, ref, qry = _flat_read_data()
    if model == PINV:
        ref, qry, _ = with_invariant_sites(ref, qry, (0.26, 0.24, 0.25,
                                                      0.25), 0.2, 3)
    opts = dict(blo_block=64, fused_topk=8)
    jeng, teng = _engines(tree, ref, model, **opts)
    plain = _port_engine(tree, ref, model, **opts)
    jeng.attach_mesh(jmesh.make_mesh(4, 2))
    teng.attach_mesh(mesh.make_mesh(4, 2, CPUS))
    assert teng._sharded.pad == 1 and teng._blo is None

    tqry = _port_msa(qry)
    assert_same_pqueries(plain.place_chunk(tqry), teng.place_chunk(tqry),
                         tol=1e-9)

    # the fused dispatch's packed, filtered output, begin-sorted and padded
    # alike by both engines
    ec = jeng.encode_msa(qry)
    want = np.asarray(jeng._dispatch_chunk_fused(ec, 0)["out"])
    got = teng._dispatch_chunk_fused(teng.encode_msa(tqry), 0)["out"].numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[[0, 5, 6]], want[[0, 5, 6]])
    np.testing.assert_allclose(got[1:3], want[1:3], rtol=0, atol=LOGL_TOL)
    np.testing.assert_allclose(got[3:5], want[3:5], rtol=0, atol=LEN_TOL)

    # the redo paths driven directly (saturation is data-dependent)
    perm = np.argsort(ec.ranges[:, 0], kind="stable")
    codes, ranges = ec.codes[perm], ec.ranges[perm]
    jq = jeng._query_tensors_codes(codes)
    tq = teng._query_tensors_codes(codes)
    pq = plain._query_tensors_codes(codes)
    for fn in ("_redo_wide", "_redo_exact"):
        args = ([0, 1, 13 if protein else 33], codes, ranges)
        rest = (perm, ec.headers, 0)
        got = getattr(teng, fn)(*args, *tq, *rest)
        assert_same_pqueries(getattr(jeng, fn)(*args, *jq, *rest), got)
        assert_same_pqueries(getattr(plain, fn)(*args, *pq, *rest), got,
                             tol=1e-9)
    assert teng.newton_work.totals()["twin_launches"] > 0


def test_attach_mesh_escalation_matches_plain():
    """The saturation-escalation ladder runs through the sharded step too:
    a fused budget of 2 saturates most queries, the wider re-dispatch
    rescues the chunk on the mesh, and the output is the plain engine's
    (same ladder on one device) and, up to ties, the exact path's."""
    tree, ref, qry = synth_dataset(n_taxa=64, sites=128, n_queries=24,
                                   seed=33)
    meshed = _port_engine(tree, ref, GTR, blo_block=64, fused_topk=2)
    plain = _port_engine(tree, ref, GTR, blo_block=64, fused_topk=2)
    meshed.attach_mesh(mesh.make_mesh(4, 2, CPUS))
    tqry = _port_msa(qry)
    got = meshed.place_chunk(tqry)
    assert meshed._escalations > 0, "ladder never engaged on the mesh"
    assert_same_pqueries(plain.place_chunk(tqry), got, tol=1e-9)
    exact = plain._place_chunk_exact(plain.encode_msa(tqry), 0)
    assert len(got) == len(exact) == 24
    for a, b in zip(got, exact):
        np.testing.assert_allclose(np.sort(a.logls), np.sort(b.logls),
                                   atol=1e-6)
        assert a.edge_nums[0] == b.edge_nums[0] or abs(
            a.logls[0] - b.logls[0]) <= 1e-6


def test_attach_mesh_refusals():
    tree, ref, _ = synth_dataset(n_taxa=8, sites=48, n_queries=2, seed=1)
    teng = _port_engine(tree, ref, GTR)
    with pytest.raises(ValueError, match="power of two"):
        teng.attach_mesh(mesh.make_mesh(3, 1, CPUS))
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        mesh.make_mesh(4, 4, CPUS)


def test_cli_mesh_equals_plain(tmp_path):
    """--mesh 4x2 --device cpu end to end through the CLI: the same jplace
    as the plain run, with the mesh in the run's stats."""
    from epa_ng_tpu_torch import cli
    tpath, rpath, qpath = synth_files(str(tmp_path), n_taxa=24, sites=96,
                                      n_queries=40, seed=3)
    base = ["-t", tpath, "-s", rpath, "-q", qpath, "-m", GTR, "--redo",
            "--device", "cpu"]
    assert torch_main(base + ["-w", str(tmp_path / "plain")]) == 0
    assert torch_main(base + ["-w", str(tmp_path / "mesh"),
                              "--mesh", "4x2"]) == 0
    assert cli.LAST_RUN_STATS["mesh"] == "4x2"
    assert cli.LAST_RUN_STATS["process_count"] == 1
    assert_same_placements(
        _placements(str(tmp_path / "plain" / "epa_result.jplace")),
        _placements(str(tmp_path / "mesh" / "epa_result.jplace")),
        rtol=1e-9)


def test_scaling_harness_smoke():
    """parallel.scaling.measure end to end on two CPU shards (its numbers
    say nothing of a card; this pins the harness: the sharded step's
    construction, the efficiency arithmetic, the result's keys)."""
    r = scaling.measure(n_devices=2, n_taxa=24, sites=96, n_queries=32,
                        device="cpu")
    assert r["metric"] == "scaling_efficiency"
    assert r["devices"] == 2 and r["device_name"] == "cpu"
    assert r["unit"] == "efficiency" and "NOT card" in r["note"]
    assert r["qps_1dev"] > 0 and r["qps_ndev"] > 0 and r["value"] > 0

"""GTDB-Tk's bac120 deployment (``benchmark/configs/gtdb-bac120-wag-g4.json``:
WAG+G4, full-width protein queries, one a genome) on the port at a CPU size:
the CLI's jplace against the benchmark's float64 plain reference, the
configuration's WAG numbers against the port's table, and the reference
state's build spans and the engine's counts in the recorder
(``utils/timer.py``)."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import compare, datagen, reference
from benchmark import run as brun
from benchmark.model import Model, exchangeabilities
from epa_ng_tpu_torch.cli import main as torch_main
from epa_ng_tpu_torch.core import chunk as chunk_mod
from epa_ng_tpu_torch.core.engine import COUNTS
from epa_ng_tpu_torch.io import fasta as fio
from epa_ng_tpu_torch.models import Model as PortModel
from epa_ng_tpu_torch.models import aa_data
from epa_ng_tpu_torch.ops import blo_kernel, eigen, newton
from epa_ng_tpu_torch.parallel import mesh
from epa_ng_tpu_torch.utils import timer

torch.set_num_threads(1)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark", "configs", "gtdb-bac120-wag-g4.json")
SEED = 2 ** 31 + 19
# the configuration cut to a CPU size: the widths stay (20 states, 4 rate
# categories, full-width reads), the taxa, columns and reads shrink. 20
# taxa give 37 edges, more than the fused step's K = 20 budget of 32
# candidates, so the dynamic heuristic takes the fused step; one chunk of
# POOL reads (no padding to 64 rows). The CPU's torch twin runs every
# padded pair in lock step: --no-heur at 256 columns took 101 s
TAXA, SITES, POOL = 20, 64, 6
CHUNK = ["--chunk-size", str(POOL)]
# the port's branch lengths are EPA-ng's Newton smoothing from the edge's
# midpoint (stopping at its own tolerance, or at an end of the edge where
# the likelihood along it is not concave), the reference's alternating
# golden-section searches: the port's best lies up to 0.24 log units below
# the reference's on this seed, the gap the cell's ``opt_gap`` limit holds
OPT_TOL = 1.0
GTR = "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G4{0.6}"


def _config() -> dict:
    with open(CONFIG) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """(dataset, files, configuration) of the cut configuration."""
    cfg = _config()
    cfg.update(taxa=TAXA, sites=SITES)
    cfg["reads"] = dict(cfg["reads"], pool=POOL, span_min=SITES,
                        span_max=SITES)
    ds = datagen.generate(cfg, SEED)
    tmp = str(tmp_path_factory.mktemp("gtdb"))
    return ds, datagen.write_files(ds, tmp), cfg


@pytest.fixture(scope="module")
def engine(cell, tmp_path_factory):
    """The engine as the CLI builds it, f64 on the CPU, with the recorder's
    totals and counts just before and just after its build."""
    ds, paths, cfg = cell
    out = str(tmp_path_factory.mktemp("engine"))
    argv = brun.cli_argv(dict(cfg, compute_dtype="f64"), {"cli": CHUNK},
                         paths, out, "cpu")
    before = timer.RECORDER.totals(), timer.RECORDER.counts()
    built = brun.build_engine(argv, "cpu")
    after = timer.RECORDER.totals(), timer.RECORDER.counts()
    return built, before, after


@pytest.mark.parametrize("heuristic", ["dyn", "noheur"])
def test_placements_against_the_plain_reference(cell, tmp_path, heuristic):
    ds, paths, cfg = cell
    out = str(tmp_path / "out")
    flags = [] if heuristic == "dyn" else ["--no-heur"]
    assert torch_main(["--tree", paths["tree"], "--ref-msa", paths["ref"],
                       "--query", paths["pool"], "--model", cfg["model"],
                       "--outdir", out, "--redo", "--device", "cpu",
                       "--compute-dtype", "f64"] + CHUNK + flags) == 0
    emap, by_name = compare.read_jplace(
        os.path.join(out, "epa_result.jplace"), ds)
    assert compare.count_missing(by_name, ds, POOL) == 0
    ref = reference.Reference(ds, Model(cfg), np.arange(SITES))
    reads = np.arange(POOL)
    rows = {q: compare.port_rows(by_name[ds.read_name(q)], emap, ds)[0]
            for q in reads}
    # (read, node, logl, lwr, distal, pendant) of every reported row
    flat = np.asarray([(q,) + r for q in reads for r in rows[q]])
    at = ref.logl_at(flat[:, 1].astype(np.int64), flat[:, 0].astype(
        np.int64), flat[:, 5], flat[:, 4])
    np.testing.assert_allclose(flat[:, 2], at, rtol=1e-6)
    best = ref.place(reads, heuristic=heuristic == "dyn",
                     threshold=0.99999, support=0.01, fmin=1, fmax=7)
    gaps = np.asarray([best[q][0] - max(r[1] for r in rows[q])
                       for q in reads])
    assert gaps.max() <= OPT_TOL, gaps


def test_configuration_states_wag():
    """The configuration's exchangeabilities and frequencies are WAG's
    published table, the one the port holds (``models/aa_data.py``), and
    its widths are the deployment's."""
    cfg = _config()
    rates, freqs = aa_data._parse(aa_data._WAG)
    assert np.array_equal(exchangeabilities(cfg)[np.triu_indices(20, 1)],
                          rates)
    stated = np.asarray(cfg["freqs"])
    assert np.array_equal(stated / stated.sum(), freqs)
    port = PortModel.from_string(cfg["model"])
    assert port.num_states == 20 and port.num_ratecats == 4
    assert np.array_equal(Model(cfg).freqs, freqs)
    assert (cfg["alphabet"], cfg["gamma_categories"], cfg["sites"]) == (
        "ARNDCQEGHILKMFPSTWYV", 4, 5040)
    assert cfg["reads"]["span_min"] == cfg["reads"]["span_max"] == 5040


def test_build_records_its_spans_and_zero_counts(engine):
    (eng, *_), before, after = engine
    spans = timer.since(before[0], after[0])
    assert {k: spans[k][0] for k in ("build.clv", "build.lookup",
                                     "build.blo")} == {
        "build.clv": 1, "build.lookup": 1, "build.blo": 1}
    counts = timer.counts_since(before[1], after[1])
    assert {k: counts[k] for k in COUNTS} == dict.fromkeys(COUNTS, 0)
    held = [eng.lookup_table] + list(eng.blo)
    assert counts["state.bytes"] == sum(t.nbytes for t in held)


def _fake_kernel(consts, tU, tV, tQ, e_ids, *args, **kw):
    n = e_ids.shape[0]
    z = torch.zeros(n, dtype=tU.dtype)
    return (z, z, z, z, z, torch.ones(n, dtype=torch.bool))


@pytest.mark.parametrize("model,width,wide", [
    ("WAG+G4{0.8}", blo_kernel.kernel_width([5040]), True),
    ("WAG+G4{0.8}", blo_kernel.max_shared_sites(80, False, 20) + 32, True),
    ("WAG+G4{0.8}", blo_kernel.max_shared_sites(80, False, 20), False),
    (GTR, blo_kernel.kernel_width([450]), False)])
def test_launches_counted_wide_past_shared_memory(monkeypatch, model, width,
                                                  wide):
    """``newton.launches_wide``: the fused step's kernel launches whose
    sumtable lives in device memory, past ``max_shared_sites`` (640 sites
    at K = 20, R = 4); ``neotrop.dyn``'s reads (up to 450 columns) stay in
    shared memory."""
    consts = newton.eig_consts(eigen.decompose(PortModel.from_string(model)),
                               torch.float64, "cpu")
    assert blo_kernel.t_in_device_memory(consts, width) is wide
    monkeypatch.setattr(mesh, "blo_optimize_batch_kernel_blocked",
                        _fake_kernel)
    K, RK = consts.A.shape[-1], consts.A.shape[-1] * consts.rates.shape[0]
    E, Q, S, B = 3, 4, 8, 4 * blo_kernel.PB
    before = timer.RECORDER.counts()
    mesh._newton_blocked_kernel(
        consts, torch.zeros(E, RK, S, dtype=torch.float64),
        torch.zeros(E, RK, S, dtype=torch.float64),
        torch.zeros(E, S, dtype=torch.float64), torch.ones(E),
        torch.zeros(Q, K, S, dtype=torch.float64),
        torch.arange(B) % E, torch.arange(B) % Q,
        torch.ones(B, dtype=torch.bool), torch.zeros(Q, dtype=torch.int32),
        torch.full((Q,), S, dtype=torch.int32), width, halve_budget=False,
        phase1=3)
    grew = timer.counts_since(before, timer.RECORDER.counts())
    # two launches: phase A and the unconverged tail's phase B
    assert grew["newton.launches"] == 2
    assert grew["newton.launches_wide"] == 2 * wide


def test_chunk_forced_off_the_fused_path_is_counted(cell, engine,
                                                    monkeypatch):
    """A chunk whose fused result is refused (as when more than a fifth of
    its reads saturate the candidate budget) and that the wide-budget
    ladder does not rescue is counted as surrendered to the exact path."""
    (eng, options, qry_info, _, _), _, _ = engine
    reader = fio.make_msa_reader(cell[1]["pool"], qry_info,
                                 options.premasking, split=True)
    ec = chunk_mod.collapse(eng.check_chunk(reader.read_next_encoded(
        POOL, eng.model.num_states)))
    monkeypatch.setattr(eng, "_finalize_chunk_fused", lambda state: None)
    before = timer.RECORDER.counts()
    handle = eng.place_encoded_async(ec)
    assert handle[0] == "fused"
    placed = eng.finalize_chunk(handle)
    grew = timer.counts_since(before, timer.RECORDER.counts())
    assert len(placed) == len(ec)
    assert (grew["fused.chunks"], grew["fused.escalated"],
            grew["fused.exact_chunks"]) == (1, 0, 1)

"""Multi-process placement through the port's CLI (``--distributed``,
``--adaptive-split``, the EPA_NG_TPU_PROCESS_* env ranks), on synthetic
data and the CPU: the tests of tests/test_multiproc_cli.py, held to the
port. Each rank places a contiguous shard of the query file and rank 0
merges the jplace fragments (the analog of the reference's MPI data
parallelism + MPI-IO collective output, src/net/epa_mpi_util.cpp:10-30,
src/io/jplace_writer.hpp:92-132). Also the port's copies of the numpy-only
helpers (``parallel/schedule.py``, ``core/work.py``, ``utils/ranges.py``)
against the JAX package's.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from epa_ng_tpu.core import work as jwork
from epa_ng_tpu.parallel import schedule as jschedule
from epa_ng_tpu.utils import ranges as jranges
from epa_ng_tpu.utils.synth import synth_files

from epa_ng_tpu_torch.cli import main, maybe_init_distributed
from epa_ng_tpu_torch.core import work
from epa_ng_tpu_torch.parallel import dist, schedule
from epa_ng_tpu_torch.utils import ranges
from test_torch_engine import _placements, assert_same_placements

# one intra-op thread per test process: the suite runs in parallel
# workers, and a thread per core in each of them oversubscribes the
# CPU and slows the small tensor ops here by orders of magnitude
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G4{0.6}"
N_QUERIES = 16
FRAG = ('    {"p": [\n      [0, -1.0, 1.0, 0.1, 0.1]\n      ],\n'
        '    "n": ["q1"]\n    }')


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    return synth_files(str(d), n_taxa=12, sites=96, n_queries=N_QUERIES,
                       seed=33)


@pytest.fixture(scope="module")
def single(files, tmp_path_factory):
    """The one-process run's jplace, by name."""
    out = tmp_path_factory.mktemp("single")
    assert main(_argv(files, out)) == 0
    return _placements(str(out / "epa_result.jplace"))


def _argv(files, outdir, redo=True, extra=()):
    tpath, rpath, qpath = files
    return (["-t", tpath, "-s", rpath, "-q", qpath, "-m", MODEL,
             "-w", str(outdir) + "/", "--device", "cpu"]
            + (["--redo"] if redo else []) + list(extra))


def _run_rank(monkeypatch, files, outdir, rank, count=2, redo=True,
              extra=()):
    with monkeypatch.context() as m:
        m.setenv("EPA_NG_TPU_PROCESS_INDEX", str(rank))
        m.setenv("EPA_NG_TPU_PROCESS_COUNT", str(count))
        assert main(_argv(files, outdir, redo, extra)) == 0


def _names(path):
    with open(path) as f:
        return [tuple(p["n"]) for p in json.load(f)["placements"]]


def _assert_merged(outdir, single, n_ranks=2):
    """The merged document places every query once, in input order, as the
    one-process run does; no shard or sidecar is left."""
    doc = os.path.join(outdir, "epa_result.jplace")
    assert _names(doc) == [(f"Q{i}",) for i in range(N_QUERIES)]
    assert_same_placements(single, _placements(doc), rtol=1e-9)
    left = [n for n in os.listdir(outdir) if ".shard" in n]
    assert not left, left


@pytest.mark.parametrize("extra", [(), ("--mesh", "2x2")],
                         ids=["plain", "mesh2x2"])
def test_two_env_ranks_merge_equals_single(monkeypatch, files, single,
                                           tmp_path, extra):
    """Two env ranks each place their own half of the queries (before,
    both placed every query into one result file) and rank 0's merge
    equals the one-process run; also with a local 2x2 mesh of CPU shards
    on each rank. Rank 1 runs first so its shard exists when rank 0
    merges (a real run orders them with the process group's barrier)."""
    from epa_ng_tpu_torch import cli
    _run_rank(monkeypatch, files, tmp_path, 1, extra=extra)
    assert cli.LAST_RUN_STATS["sequences"] == N_QUERIES // 2
    assert cli.LAST_RUN_STATS["process_index"] == 1
    _run_rank(monkeypatch, files, tmp_path, 0, extra=extra)
    assert cli.LAST_RUN_STATS["process_count"] == 2
    assert cli.LAST_RUN_STATS["mesh"] == ("2x2" if extra else None)
    _assert_merged(tmp_path, single)


def test_per_rank_logs_and_rank1_silent(monkeypatch, files, tmp_path,
                                        capsys):
    """Each rank writes its own N.epa_info.log (reference:
    src/main.cpp:309-313) — WITHOUT --redo, so ranks sharing one
    epa_info.log would trip the overwrite guard — and only rank 0 logs to
    stdout."""
    capsys.readouterr()
    _run_rank(monkeypatch, files, tmp_path, 1, redo=False)
    assert "Sequences done" not in capsys.readouterr().out
    _run_rank(monkeypatch, files, tmp_path, 0, redo=False)
    assert "Sequences done" in capsys.readouterr().out
    assert "Sequences done" in (tmp_path / "1.epa_info.log").read_text()
    assert (tmp_path / "0.epa_info.log").exists()
    assert not (tmp_path / "epa_info.log").exists()
    assert len(_names(tmp_path / "epa_result.jplace")) == N_QUERIES


@pytest.mark.parametrize("case", ["missing", "truncated", "no_sidecar"])
def test_merge_refuses_partial_shards(tmp_path, case):
    """A rank that never wrote its shard, a shard whose .count sidecar
    disagrees with its content, or one without a sidecar aborts the
    merge, and no partial document is left at the result path."""
    (tmp_path / "epa_result.jplace.shard0").write_text(FRAG)
    count = 2 if case == "missing" else 1
    if case != "no_sidecar":
        (tmp_path / "epa_result.jplace.shard0.count").write_text(
            "2" if case == "truncated" else "1")
    match = {"missing": r"missing shard\(s\) \[1\]",
             "truncated": "truncated", "no_sidecar": "sidecar"}[case]
    with pytest.raises(RuntimeError, match=match):
        dist.merge_jplace_shards(str(tmp_path), "epa_result.jplace", count,
                                 "(a,b);", "inv")
    assert not (tmp_path / "epa_result.jplace").exists()
    assert not (tmp_path / "epa_result.jplace.merging").exists()


def test_result_overwrite_guard(files, tmp_path):
    """epa_result.jplace itself is --redo-guarded, apart from the log file
    (reference: src/main.cpp:315-320)."""
    assert main(_argv(files, tmp_path, redo=False)) == 0
    before = (tmp_path / "epa_result.jplace").read_text()
    (tmp_path / "epa_info.log").unlink()
    assert main(_argv(files, tmp_path, redo=False)) == 1
    assert (tmp_path / "epa_result.jplace").read_text() == before


def test_adaptive_split_two_ranks(monkeypatch, files, single, tmp_path):
    """--adaptive-split with forced 3:1 rates: rank 0 places 12 of the 16
    queries, and the merged document is the one-process run's."""
    monkeypatch.setenv("EPA_NG_TPU_CALIBRATION_RATES", "3,1")
    for rank in (1, 0):
        _run_rank(monkeypatch, files, tmp_path, rank,
                  extra=("--adaptive-split",))
    from epa_ng_tpu_torch import cli
    assert cli.LAST_RUN_STATS["adaptive_shard"] == [0, 12]
    assert "offset 0, 12 queries" in (tmp_path / "0.epa_info.log"
                                      ).read_text()
    assert "offset 12, 4 queries" in (tmp_path / "1.epa_info.log"
                                      ).read_text()
    _assert_merged(tmp_path, single)


@pytest.mark.parametrize("total,rates", [
    (100, [3.0, 1.0]), (10, [1, 1, 1]), (8, [0.0, 0.0]),
    (2, [100.0, 0.001]), (1000, [0.3, 2.7, 1.1, 0.9]), (0, [1.0, 2.0])])
def test_proportional_shares_match_jax(total, rates):
    got = schedule.proportional_shares(total, rates)
    assert got == jschedule.proportional_shares(total, rates)
    assert sum(c for _, c in got) == total
    assert all(got[i][0] == got[i - 1][0] + got[i - 1][1]
               for i in range(1, len(got)))


def test_schedule_solver_matches_jax():
    for stages, nodes, diff in ((3, 5, [1.0, 4.0, 1.0]),
                                (4, 10, [1.0, 2.5, 3.0, 1.0])):
        assert (schedule.solve(stages, nodes, diff)
                == jschedule.solve(stages, nodes, diff))
    assert (schedule.to_difficulty([2.0, 6.0, 3.0])
            == jschedule.to_difficulty([2.0, 6.0, 3.0]))
    a, stage = schedule.assign(3, [1, 3, 1])
    assert (a, stage) == jschedule.assign(3, [1, 3, 1])
    ja = [list(x) for x in a]
    assert (schedule.reassign(3, [2, 2, 1], a, stage)
            == jschedule.reassign(3, [2, 2, 1], ja, stage))
    assert a == ja
    with pytest.raises(ValueError):
        schedule.solve(3, 2, [1.0, 1.0, 1.0])


def test_work_and_ranges_match_jax():
    rng = np.random.default_rng(4)
    e = rng.integers(0, 9, 40)
    q = rng.integers(0, 7, 40)
    tw, jw = work.Work.from_pairs(e, q), jwork.Work.from_pairs(e, q)
    for a, b in zip(tw.pairs(), jw.pairs()):
        np.testing.assert_array_equal(a, b)
    for n in (1, 3, 7, 50):
        got = [list(p) for p in work.split(tw, n)]
        assert got == [list(p) for p in jwork.split(jw, n)]
    assert list(work.merge(work.Work(), tw)) == list(tw)
    assert (list(work.Work.from_ranges((2, 5), (0, 3)))
            == list(jwork.Work.from_ranges((2, 5), (0, 3))))
    seqs = ["--ACGT-", "ACGT", "----", "A--C", "-"]
    np.testing.assert_array_equal(ranges.valid_ranges(seqs),
                                  jranges.valid_ranges(seqs))
    assert ranges.get_valid_range("--AC-G--") == (2, 4)


@pytest.mark.parametrize("spec", ["nonsense-without-commas",
                                  "127.0.0.1:1,2,5", "127.0.0.1:1,x,0"])
def test_bad_distributed_spec(spec):
    with pytest.raises(SystemExit, match="bad --distributed spec"):
        maybe_init_distributed(spec)


def test_distributed_auto_needs_a_launcher(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS",
                "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="found no torchrun"):
        maybe_init_distributed("auto")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gloo_pair(files, outdir, extra=()):
    """Two real processes joined by ``--distributed 127.0.0.1:PORT,2,RANK``
    (a gloo group over localhost); returns their outputs."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("EPA_NG_TPU_")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "epa_ng_tpu_torch.cli",
         *_argv(files, outdir, extra=extra),
         "--distributed", f"{coord},2,{rank}"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0].decode())
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


@pytest.mark.parametrize("extra", [(), ("--adaptive-split", "-G", "0.2")],
                         ids=["even", "adaptive"])
def test_two_gloo_processes(files, single, tmp_path, extra):
    """Two real processes through ``--distributed``: the process group's
    barrier orders rank 0's merge after rank 1's shard, and the merged
    document is the one-process run's. With --adaptive-split the ranks
    calibrate, gather their rates over the group, and split the file at
    one offset: the shards cover it once, and each rank's log says its
    share. (Under the fixed heuristic: the dynamic one sends the
    calibration's random reads on this 21-edge tree through the exact
    path, seconds on the CPU.)"""
    outs = _gloo_pair(files, tmp_path, extra)
    assert "Sequences done" not in outs[1]
    if extra:
        assert main(_argv(files, tmp_path / "single", extra=extra[1:])) == 0
        single = _placements(str(tmp_path / "single" / "epa_result.jplace"))
    _assert_merged(tmp_path, single)
    logs = [(tmp_path / f"{r}.epa_info.log").read_text() for r in (0, 1)]
    if extra:
        shares = [line.split("this rank: ")[1] for log in logs
                  for line in log.splitlines() if "this rank: " in line]
        assert len(shares) == 2, logs
        n0 = int(shares[0].split(", ")[1].split()[0])
        assert shares[0] == f"offset 0, {n0} queries)"
        assert shares[1] == f"offset {n0}, {N_QUERIES - n0} queries)"
        assert "Calibrating placement rate" in logs[1]

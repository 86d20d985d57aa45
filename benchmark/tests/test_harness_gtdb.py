"""The ``gtdb.dyn`` cell's configuration (GTDB-Tk's bac120 deployment: WAG+G4,
full-width protein queries) run whole on the CPU at a tiny size, with the
readers of the program's build spans and fused-path counts; and, as on a
parent that lacks those spans and counts, the same readers left out as
absent with the line printed."""

import json
import os
import time

from benchmark import run as brun
from benchmark.registry import Registry
from benchmark.tests.test_harness_absent import _Without
from benchmark.tests.tiny import CELL, tiny_registry
from epa_ng_tpu_torch.utils import timer

SEED = 2 ** 31 + 1019
SITES = 64
NEW = {"build_lookup_s.gtdb": ("build.lookup",),
       "build_blo_s.gtdb": ("build.blo",),
       "exact_chunk_pct.gtdb": ("fused.chunks", "fused.exact_chunks")}
# what a CPU run reads of the cell's per-layer metrics: the host's and the
# program's recorder's (the device trace needs the card)
ON_THE_CPU = ("host_clock", "program_span", "program_counter")


def _registry(tmp_path) -> Registry:
    """The tiny cell of the gtdb configuration: 20 taxa (37 edges, past the
    fused step's K = 20 budget of 32 candidates), full-width reads of 64
    columns, reporting the cell's per-layer metrics that a CPU run reads."""
    reg = tiny_registry(tmp_path, config="gtdb-bac120-wag-g4", taxa=20,
                        sites=SITES, span=(SITES, SITES), pool=16, chunk=8,
                        sample=8)
    spec = reg.spec
    spec["per_layer"] = [m for m in spec["per_layer"]
                         if m["source"] in ON_THE_CPU
                         and "gtdb.dyn" in m["workloads"]]
    for m in spec["per_layer"]:
        m["workloads"] = [CELL]
    path = os.path.join(reg.base, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return Registry(path, reg.base)


def _run_and_finish(reg, capsys):
    record = brun.RunRecord()
    res = brun.run(reg, reg.workload(CELL), SEED, 1.0, True, device="cpu",
                   t_start=time.perf_counter(), record=record)
    capsys.readouterr()
    rc = brun.finish(reg, reg.workload(CELL), res, record)
    out, err = capsys.readouterr()
    return res, record, rc, out, err


def test_gtdb_cell_runs_whole_and_reads_its_new_metrics(tmp_path, capsys):
    reg = _registry(tmp_path)
    for name, declared in NEW.items():
        assert sum(reg.program_names(name), ()) == declared
    res, record, rc, out, err = _run_and_finish(reg, capsys)
    assert rc == 0 and res["correct"], err
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line["metrics"]) == {m["name"] for m in reg.spec["per_layer"]}
    got = {k: line["metrics"][k]["value"] for k in NEW}
    run = record.program_run_totals
    assert got["build_lookup_s.gtdb"] == run["build.lookup"][1] > 0
    assert got["build_blo_s.gtdb"] == run["build.blo"][1] > 0
    # every chunk of the window took the fused step and stayed on it
    assert record.program_counts["fused.chunks"] > 0
    assert got["exact_chunk_pct.gtdb"] == 0.0
    assert "absent" not in err


def test_gtdb_readers_absent_on_a_program_without_them(tmp_path, capsys,
                                                       monkeypatch):
    """The parent of the change that adds the build spans and the engine's
    counts records none of them: their readers are absent, the rest read,
    and the run prints its line with exit 0."""
    names = [n for declared in NEW.values() for n in declared]
    monkeypatch.setattr(timer, "RECORDER", _Without(timer.RECORDER, names))
    reg = _registry(tmp_path)
    res, record, rc, out, err = _run_and_finish(reg, capsys)
    assert rc == 0 and res["correct"]
    absent, silent = brun.silent_metrics(reg, reg.workload(CELL), res,
                                         record)
    assert sorted(absent) == sorted(NEW) and silent == []
    line = json.loads(out.strip().splitlines()[-1])
    assert not set(NEW) & set(line["metrics"])
    assert {"qps.gtdb", "dispatch_cpu_us_per_q.gtdb",
            "build_s.gtdb"} <= set(line["metrics"])
    assert f"metrics absent from this program: {absent}" in err

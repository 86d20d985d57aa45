"""Metrics that read nothing, sorted by ``run.silent_metrics`` on whole
runs of the tiny cell: a metric whose reader names a span or count that
the program never records is absent (left out, the run prints its line and
exits 0); any other metric that reads nothing is silent and stops the run
(exit 4). And the readers of the program's own spans read what its
recorder holds over the window."""

import json
import os
import time

import pytest

from benchmark import run as brun
from benchmark.registry import Registry
from benchmark.tests.tiny import CELL, tiny_registry
from epa_ng_tpu_torch.utils import timer

SEED = 2 ** 31 + 29
PROGRAM_SPAN_READERS = {"dispatch_cpu_us_per_q.dyn": "dispatch",
                        "emit_cpu_us_per_q.dyn": "emit",
                        "read_cpu_us_per_q.dyn": "read"}
NOTHING = "def read(run):\n    return None\n"


def _registry(tmp_path, readers: dict | None = None) -> Registry:
    """The tiny cell listing the per-layer metrics a CPU run reads (those
    of host spans) and the throwaway ``readers`` (name -> source)."""
    reg = tiny_registry(tmp_path)
    spec = reg.spec
    spec["per_layer"] = [m for m in spec["per_layer"]
                         if m["source"] == "program_span"
                         and CELL in m["workloads"]]
    for name, src in (readers or {}).items():
        with open(os.path.join(reg.base, "metrics", f"{name}.py"), "w") as f:
            f.write(src)
        spec["per_layer"].append({
            "name": name, "unit": "us", "better": "lower",
            "source": "program_span", "layer": "engine",
            "moves": "card_ms_per_kq",
            "workloads": [CELL]})
    path = os.path.join(reg.base, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return Registry(path, reg.base)


def _run(reg):
    record = brun.RunRecord()
    res = brun.run(reg, reg.workload(CELL), SEED, 1.0, True, device="cpu",
                   t_start=time.perf_counter(), record=record)
    return res, record


def _finish(reg, res, record, capsys):
    capsys.readouterr()
    rc = brun.finish(reg, reg.workload(CELL), res, record)
    out, err = capsys.readouterr()
    return rc, out, err


class _Without:
    """The program's recorder as a program that never records ``names``
    shows it."""

    def __init__(self, rec, names):
        self._rec, self._names = rec, set(names)

    def totals(self):
        return {k: v for k, v in self._rec.totals().items()
                if k not in self._names}

    def counts(self):
        return {k: v for k, v in self._rec.counts().items()
                if k not in self._names}

    def window(self, t0_ns, t1_ns):
        spans = self._rec.window(t0_ns, t1_ns)
        return spans and [s for s in spans if s.name not in self._names]


@pytest.mark.parametrize("declares", [
    'SPANS = ("no.such.span",)', 'COUNTS = ("no.such.count",)',
    'SPANS = ("dispatch", "no.such.span")'])
def test_name_the_program_never_records_is_absent(tmp_path, capsys,
                                                  declares):
    reg = _registry(tmp_path, {"ghost_us_per_q": f"{declares}\n\n{NOTHING}"})
    res, record = _run(reg)
    assert brun.silent_metrics(reg, reg.workload(CELL), res, record) == (
        ["ghost_us_per_q"], [])
    rc, out, err = _finish(reg, res, record, capsys)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] and "ghost_us_per_q" not in line["metrics"]
    assert set(PROGRAM_SPAN_READERS) <= set(line["metrics"])
    assert "metrics absent from this program: ['ghost_us_per_q']" in err
    # the numbers compared still close standard error
    assert err.strip().splitlines()[-1].startswith(list(res["checks"])[-1])


@pytest.mark.parametrize("program", ["without_dispatch", "no_recorder"])
def test_older_program_leaves_its_readers_absent(tmp_path, capsys,
                                                 monkeypatch, program):
    """A change's parent that lacks a span the change adds (or lacks the
    recorder): the metrics that read it are absent, the rest read."""
    if program == "no_recorder":
        monkeypatch.delattr(timer, "RECORDER")
        want = sorted(PROGRAM_SPAN_READERS)
    else:
        monkeypatch.setattr(timer, "RECORDER",
                            _Without(timer.RECORDER, ["dispatch"]))
        want = ["dispatch_cpu_us_per_q.dyn"]
    reg = _registry(tmp_path)
    res, record = _run(reg)
    absent, silent = brun.silent_metrics(reg, reg.workload(CELL), res,
                                         record)
    assert sorted(absent) == want and silent == []
    rc, out, err = _finish(reg, res, record, capsys)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert not set(want) & set(line["metrics"])
    assert "read_us_per_q.dyn" in line["metrics"]
    assert "metrics absent from this program" in err


@pytest.mark.parametrize("declares", ["", 'SPANS = ("dispatch",)\n\n'])
def test_metric_that_reads_nothing_stops_the_run(tmp_path, capsys,
                                                 declares):
    """A reader that declares nothing, or whose declared span the program
    records, and reads nothing: silent, exit 4, no result line."""
    reg = _registry(tmp_path, {"quiet_us_per_q": declares + NOTHING})
    res, record = _run(reg)
    assert brun.silent_metrics(reg, reg.workload(CELL), res, record) == (
        [], ["quiet_us_per_q"])
    rc, out, err = _finish(reg, res, record, capsys)
    assert rc == 4 and out == ""
    assert "metrics of this cell that read nothing: ['quiet_us_per_q']" \
        in err


def test_program_span_readers_read_the_window(tmp_path):
    reg = tiny_registry(tmp_path)
    res, record = _run(reg)
    assert record.written > 0 and record.program_spans
    for metric, name in PROGRAM_SPAN_READERS.items():
        assert reg.program_names(metric) == ((name,), ())
        count, _, cpu_s = record.program_totals[name]
        value = res["metrics"][metric]["value"]
        assert value > 0 and res["metrics"][metric]["unit"] == "us"
        assert value == pytest.approx(cpu_s * 1e6 / record.written,
                                      rel=1e-12)
        # the snapshots around the window hold the spans the ring has in it
        spans = [s for s in record.program_spans if s.name == name]
        assert len(spans) == count
        assert sum(s.cpu_ns for s in spans) / 1e9 == pytest.approx(
            cpu_s, rel=1e-9, abs=1e-9)
    assert record.program_run_totals["dispatch"][0] > \
        record.program_totals["dispatch"][0]    # the warm-up chunk's
    assert set(record.program_counts) <= set(record.program_run_counts)

"""The port's span recorder (``epa_ng_tpu_torch/utils/timer.py``): the
pipeline's spans by stage, thread and chunk; waiting told apart from
work; nesting and errors; the ring's bound and the spans over a window;
the totals between two readings; the CLI's stage totals and line."""

import logging
import time

import pytest
import torch

from epa_ng_tpu_torch.cli import LAST_RUN_STATS
from epa_ng_tpu_torch.cli import main as torch_main
from epa_ng_tpu_torch.core.pipeline import StreamingPipeline
from epa_ng_tpu_torch.utils import timer
from epa_ng_tpu_torch.utils.synth import synth_files

torch.set_num_threads(1)

MS = 1_000_000
GTR = "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G4{0.6}"


def _run_pipeline(n_chunks, read_sleep=0.0):
    chunks = iter(range(n_chunks))

    def read_chunk():
        with timer.span("read.scan"):
            time.sleep(read_sleep)
            return next(chunks, None)

    def write(result):
        with timer.span("finalize"):
            with timer.span("finalize.sync"):
                pass
        with timer.span("emit"):
            assert result[0] == "placed"

    t0 = time.time_ns()
    n = StreamingPipeline(read_chunk, lambda c, i: ("placed", c),
                          write).run()
    assert n == n_chunks
    return [s for s in timer.RECORDER.spans() if s.start_ns >= t0]


def test_pipeline_spans_by_stage_thread_and_chunk():
    spans = _run_pipeline(4)
    by_id = {s.id: s for s in spans}
    threads = {"read": "pipeline-reader", "read.scan": "pipeline-reader",
               "wait_chunk": "MainThread", "dispatch": "MainThread",
               "wait_writer": "MainThread", "write": "pipeline-writer",
               "finalize": "pipeline-writer",
               "finalize.sync": "pipeline-writer",
               "emit": "pipeline-writer"}
    for i in range(4):
        names = sorted(s.name for s in spans if s.chunk == i)
        assert names == sorted(threads), (i, names)
    # the last read finds nothing, and the dispatcher's last wait gets
    # the end of the stream
    assert sorted(s.name for s in spans if s.chunk == 4) == [
        "read", "read.scan", "wait_chunk"]
    parents = {"read.scan": "read", "finalize": "write",
               "finalize.sync": "finalize", "emit": "write"}
    for s in spans:
        assert s.thread == threads[s.name], s
        assert s.start_ns <= s.end_ns and 0 <= s.cpu_ns
        if s.name in parents:
            up = by_id[s.parent]
            assert up.name == parents[s.name] and up.chunk == s.chunk
            assert up.thread == s.thread
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
        else:
            assert s.parent is None, s


def test_slow_read_shows_as_waiting():
    spans = _run_pipeline(3, read_sleep=0.05)
    for i in range(3):
        wait = [s for s in spans if s.name == "wait_chunk" and s.chunk == i]
        assert wait[0].wall_ns >= 40 * MS
        read = [s for s in spans if s.name == "read" and s.chunk == i][0]
        assert read.wall_ns >= 50 * MS and read.cpu_ns < read.wall_ns / 5


def test_ring_bound_dropped_count_and_totals():
    rec = timer.SpanRecorder(capacity=8)
    marks = []
    for i in range(20):
        with rec.span("a" if i % 2 else "b", chunk=i):
            marks.append(time.time_ns())
    kept = rec.spans()
    assert len(kept) == 8 and rec.dropped == 12
    assert [s.chunk for s in kept] == list(range(12, 20))
    tot = rec.totals()
    assert tot["a"][0] == 10 and tot["b"][0] == 10
    assert sum(s.wall_ns for s in kept) / 1e9 <= tot["a"][1] + tot["b"][1]
    # a window over dropped spans reads nothing; one after them reads all
    assert rec.window(marks[0], marks[-1]) is None
    late = rec.window(marks[13], marks[-1])
    assert [s.chunk for s in late] == list(range(13, 20))


def test_cli_stage_stats_are_the_recorder_totals(tmp_path, caplog):
    tree, ref, qry = synth_files(str(tmp_path), n_taxa=12, sites=80,
                                 n_queries=24, seed=4)
    before = timer.RECORDER.totals()
    t0 = time.time_ns()
    caplog.set_level(logging.INFO, logger="epa_ng_tpu_torch")
    assert torch_main(["--tree", tree, "--ref-msa", ref, "--query", qry,
                       "--model", GTR, "--outdir", str(tmp_path / "out"),
                       "--redo", "--device", "cpu", "--chunk-size",
                       "8"]) == 0
    run = timer.since(before, timer.RECORDER.totals())
    for key, name in (("read_s", "read"), ("compute_s", "dispatch"),
                      ("write_s", "write"), ("finalize_s", "finalize"),
                      ("emit_s", "emit")):
        assert LAST_RUN_STATS[key] == pytest.approx(run[name][1],
                                                    rel=1e-12), key
        assert LAST_RUN_STATS["stages"][name] == run[name]
    assert run["dispatch"][0] == 3 and run["finalize"][0] == 3
    # chunk granularity: a handful of spans a chunk
    spans = [s for s in timer.RECORDER.spans() if s.start_ns >= t0]
    for i in range(3):
        assert 5 <= sum(s.chunk == i for s in spans) <= 12
    # the end-of-run stage line: each stage's wall and CPU, the two waits
    line = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("Stage times, wall / CPU: ")]
    assert len(line) == 1
    for name in ("read", "read.scan", "dispatch", "write", "finalize",
                 "finalize.sync", "emit"):
        assert f" {name} " in line[0]
    assert "waiting for a chunk" in line[0] and "for the writer" in line[0]


def test_nested_spans_take_the_parent_chunk():
    rec = timer.SpanRecorder()
    with rec.span("write", chunk=3):
        with rec.span("finalize"):
            with rec.span("finalize.sync"):
                pass
        with rec.span("emit", chunk=7):
            pass
    got = {s.name: s for s in rec.spans()}
    assert [got[n].chunk for n in ("write", "finalize", "finalize.sync",
                                   "emit")] == [3, 3, 3, 7]
    assert got["finalize.sync"].parent == got["finalize"].id
    assert got["finalize"].parent == got["write"].id
    assert got["emit"].parent == got["write"].id


def test_span_records_and_unwinds_on_error():
    rec = timer.SpanRecorder()
    with pytest.raises(ValueError):
        with rec.span("write", chunk=0):
            with rec.span("emit"):
                raise ValueError("disk full")
    assert [s.name for s in rec.spans()] == ["emit", "write"]
    # the stack unwound: the next span nests in nothing
    with rec.span("read", chunk=1):
        pass
    assert rec.spans()[-1].parent is None
    assert rec.totals()["emit"][0] == 1


def test_since_counts_only_what_ran_between():
    before = {"read": (2, 1.0, 0.5), "emit": (1, 0.25, 0.25)}
    after = {"read": (5, 4.0, 2.0), "emit": (1, 0.25, 0.25),
             "dispatch": (3, 0.75, 0.5)}
    assert timer.since(before, after) == {"read": (3, 3.0, 1.5),
                                          "dispatch": (3, 0.75, 0.5)}
    assert timer.since(after, after) == {}


# spans (name, start, end) recorded in the order they end, then the
# window [1000, 2000] asked of a ring that holds ``capacity``
WARM = [("read", 100, 200), ("emit", 150, 300)]
RUN = [("read", 990, 1100), ("dispatch", 1120, 1200),
       ("emit", 1400, 1500), ("emit", 1900, 2050)]
LATE = [("read", 2100, 2200)]


@pytest.mark.parametrize("spans, capacity, want", [
    # spans that reach into the window count, those wholly outside not
    (WARM + RUN + LATE, 64, ["read", "dispatch", "emit", "emit"]),
    # the ring dropped only spans over before the window opened
    (WARM + RUN + LATE, 5, ["read", "dispatch", "emit", "emit"]),
    # the ring dropped a span that reached into the window
    (WARM + RUN + LATE, 3, None),
    # nothing ran in the window
    (WARM + LATE, 64, []),
], ids=["overlap", "dropped_before", "dropped_inside", "empty"])
def test_window(spans, capacity, want):
    rec = timer.SpanRecorder(capacity)
    for i, (name, s, e) in enumerate(spans):
        rec._add(timer.Span(i, name, None, i, "t", s, e, 0))
    got = rec.window(1000, 2000)
    assert (None if got is None else [s.name for s in got]) == want

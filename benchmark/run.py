"""Run one cell of the benchmark and print its result line.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (counted in ``setup_s``): the data from the seed (tree, reference
alignment, read pool) written to FASTA under ``TMPDIR``; the reference
state built by the port's engine from the CLI's own parser and options
(``build_s``); one chunk of the pool placed to warm the cell's shapes and
build the kernel (only a checkout's first run compiles).

The window: the CLI's placement loop (``cli._place``: the FASTA reader,
encode and collapse; ``place_encoded_async``; ``finalize_chunk``;
``JplaceWriter.write``, under ``StreamingPipeline``) cycling the pool from
its start. It opens at the first read, stops reading after ``--seconds``,
drains the chunks in flight and closes at the last jplace write; the rate
is every read written over all of that time, and the card's time a read
(``card_ms_per_kq``) the union of the device's operations in that time,
from the profiler, which runs over every window on the card, over every
read written.

Then, with the program's state freed: the jplace parsed back and a sample
of its reads, drawn from the seed, held against the plain reference
(``benchmark/compare.py``). The last line of standard output is the
result; the numbers compared, each beside its limit, close standard error.

Exit codes: 2 without the card the cell asks for; 4 when a metric the cell
lists reads nothing although the program records what it reads
(``silent_metrics``); 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import subprocess
import sys
import tempfile
import time

_T0 = time.perf_counter()

FORBIDDEN = ("jax", "jaxlib", "flax", "epa_ng_tpu")


class Spans:
    """The harness's host spans: (stage, start_ns, end_ns) on the
    profiler's clock, and their totals."""

    def __init__(self):
        self.records = []

    def timed(self, stage: str, fn, *a):
        t = time.time_ns()
        try:
            return fn(*a)
        finally:
            self.records.append((stage, t, time.time_ns()))

    def total_s(self, stage: str) -> float:
        return sum(e - s for n, s, e in self.records if n == stage) / 1e9


class Window:
    """The CLI's placement loop over the read pool, cycled from its start."""

    def __init__(self, engine, options, pool_path, qry_info, writer):
        self.engine, self.options = engine, options
        self.pool, self.info, self.writer = pool_path, qry_info, writer
        self.spans = Spans()
        self.dispatched = 0     # reads handed to the engine
        self.written = 0        # reads whose entries were written
        self.passes = 0

    def _reader(self):
        from epa_ng_tpu_torch.io import fasta as fio
        self.passes += 1
        return fio.make_msa_reader(self.pool, self.info,
                                   self.options.premasking, split=True)

    def _read(self):
        from epa_ng_tpu_torch.core import chunk as chunk_mod
        engine, size = self.engine, self.options.chunk_size
        for _ in range(2):
            read_encoded = getattr(self.reader, "read_next_encoded", None)
            if read_encoded is not None:
                ec = read_encoded(size, engine.model.num_states)
                if ec is not None and len(ec):
                    return chunk_mod.collapse(engine.check_chunk(ec))
            else:
                chunk = self.reader.read_next(size)
                if len(chunk):
                    return chunk_mod.collapse(engine.encode_msa(chunk))
            self.reader = self._reader()     # the pool's end: a new pass
        raise RuntimeError("the read pool is empty")

    def run(self, seconds: float | None = None, max_chunks: int | None = None):
        from epa_ng_tpu_torch.core.pipeline import StreamingPipeline
        self.reader = self._reader()
        chunks = [0]
        deadline = [None]

        def read_chunk():
            if max_chunks is not None and chunks[0] >= max_chunks:
                return None
            if deadline[0] is not None and time.perf_counter() >= deadline[0]:
                return None
            ec = self.spans.timed("read", self._read)
            chunks[0] += 1
            return ec

        def compute(ec, index):
            handle = self.spans.timed("dispatch",
                                      self.engine.place_encoded_async, ec,
                                      self.dispatched)
            self.dispatched += ec.num_reads
            return handle, ec.num_reads

        def write(item):
            handle, nreads = item
            result = self.spans.timed("finalize", self.engine.finalize_chunk,
                                      handle)
            self.spans.timed("emit", self.writer.write, result)
            self.written += nreads

        self.t0_ns = time.time_ns()
        t0 = time.perf_counter()
        if seconds is not None:
            deadline[0] = t0 + seconds
        StreamingPipeline(read_chunk, compute, write).run()
        self.spans.timed("emit", self.writer.close)
        self.t1_ns = time.time_ns()
        self.seconds = time.perf_counter() - t0
        return self


class RunRecord:
    """What a metric reader reads (``benchmark/metrics/<name>.py``).

    From the program's own recorder (``epa_ng_tpu_torch.utils.timer``),
    read just before the window opens and just after it closes:
    ``program_totals`` (span name -> (count, wall s, thread CPU s) of the
    spans that ran in between), ``program_counts`` (count name -> what it
    grew by), ``program_run_totals`` / ``program_run_counts`` (the whole
    run, warm-up included) and ``program_spans`` (the spans overlapping
    the window, None when the recorder's ring dropped one). All None where
    the program has no recorder.
    """

    def __init__(self, **kw):
        self.memory = 0
        self.trace = False
        self.timeline = None
        self.newton = None
        self.program_totals = self.program_counts = None
        self.program_run_totals = self.program_run_counts = None
        self.program_spans = None
        self.__dict__.update(kw)

    @property
    def rate(self) -> float:
        return self.written / self.window_s

    def span_us_per_query(self, stage: str) -> float:
        return self.spans.total_s(stage) * 1e6 / self.written

    def program_cpu_us_per_query(self, name: str):
        """Thread CPU microseconds a read written of the program's span
        ``name`` over the window; None where it did not run there."""
        t = (self.program_totals or {}).get(name)
        if t is None or not self.written:
            return None
        return t[2] * 1e6 / self.written


def program_recorder():
    """The program's span recorder, or None where it has none."""
    try:
        from epa_ng_tpu_torch.utils import timer
    except ImportError:
        return None
    return getattr(timer, "RECORDER", None)


def spans_since(before: dict, after: dict) -> dict:
    """The span totals (``RECORDER.totals()``) of the spans that ran
    between two readings. The harness's own copy of ``timer.since``, as
    the reduction from spans to metrics is the yardstick's."""
    out = {}
    for k, (c, w, u) in after.items():
        c0, w0, u0 = before.get(k, (0, 0.0, 0.0))
        if c > c0:
            out[k] = (c - c0, w - w0, u - u0)
    return out


def counts_since(before: dict, after: dict) -> dict:
    """What each count grew by between two readings."""
    return {k: n - before.get(k, 0) for k, n in after.items()}


def cli_argv(cfg: dict, mix: dict, paths: dict, outdir: str,
             device: str) -> list:
    return (["--tree", paths["tree"], "--ref-msa", paths["ref"],
             "--query", paths["pool"], "--model", cfg["model"],
             "--outdir", outdir, "--redo", "--device", device,
             "--compute-dtype", cfg["compute_dtype"]]
            + list(cfg.get("cli", [])) + list(mix.get("cli", [])))


def build_engine(argv: list, device: str):
    """The reference state as ``cli._place`` builds it for these flags
    (no --binary, --mesh, --memsave or --opt-model): (engine, options,
    query info, invocation, build seconds)."""
    from epa_ng_tpu_torch.cli import build_parser, options_from_args
    from epa_ng_tpu_torch.core.engine import (PlacementEngine,
                                              _check_device_model)
    from epa_ng_tpu_torch.io import fasta as fio
    from epa_ng_tpu_torch.models import Model
    from epa_ng_tpu_torch.tree import Tree
    args = build_parser().parse_args(argv)
    options = options_from_args(args)
    for flag in ("binary", "mesh", "memsave", "opt_model", "distributed"):
        if getattr(args, flag):
            raise ValueError(f"the harness does not mirror --{flag}")
    model = Model.from_string(args.model)
    ref_info = fio.make_msa_info(args.ref_msa)
    qry_info = fio.make_msa_info(args.query)
    premask = options.premasking and not options.dump_binary_mode
    if premask:
        fio.MSAInfo.or_mask(ref_info, qry_info)
    ref_msa = fio.build_msa_from_file(args.ref_msa, ref_info, premask)
    tree = Tree.from_file(args.tree, options.preserve_rooting)
    t = time.perf_counter()
    _check_device_model(__import__("torch").device(device), model,
                        options.sliding_blo)
    engine = PlacementEngine(tree, ref_msa, model, options, device=device)
    build_s = time.perf_counter() - t
    invocation = "epa-ng-tpu-torch " + " ".join(argv)
    return engine, options, qry_info, invocation, build_s


def writer_for(engine, options, outdir: str, name: str, invocation: str):
    from epa_ng_tpu_torch.io.jplace import JplaceWriter
    tree = engine.tree
    return JplaceWriter(outdir, name, tree.numbered_newick(options.precision),
                        invocation, tree.mapper, precision=options.precision)


def check(ds, cfg, options, limits, jplace_path, attempted, seed, device):
    """(numbers, correct, failed) of the window's output."""
    import numpy as np
    from benchmark import compare, datagen, reference
    from benchmark.model import Model
    dynamic = not (options.baseball or options.prescoring_by_percentage)
    if options.acc_threshold or (options.prescoring and not dynamic):
        raise NotImplementedError("the reference knows the dynamic "
                                  "heuristic and the min-LWR filter only")
    try:
        emap, by_name = compare.read_jplace(jplace_path, ds)
    except (ValueError, KeyError) as e:
        print(f"the window's jplace does not parse: {e}", file=sys.stderr)
        nums = dict.fromkeys(compare.NUMBERS, float("inf"))
        nums["missing"] = attempted
        return nums, False, attempted
    Q = ds.num_reads
    seen = min(attempted, Q)
    rng = datagen.stream(seed, datagen.SAMPLE)
    picks = rng.choice(seen, size=min(limits["sample"], seen), replace=False)
    longest = int(np.argmax(ds.read_span[:seen]))
    picks = np.unique(np.append(picks, longest))
    cols = np.unique(np.concatenate(
        [np.arange(b, b + s) for b, s in
         zip(ds.read_begin[picks], ds.read_span[picks])]))
    ref = reference.Reference(ds, Model(cfg), cols, device=device)
    ro = ref.place(picks, heuristic=options.prescoring,
                   threshold=options.prescoring_threshold,
                   support=options.support_threshold,
                   fmin=max(1, options.filter_min), fmax=options.filter_max)
    port = {int(q): compare.port_rows(by_name.get(ds.read_name(q), []), emap,
                                      ds) for q in picks}
    nums = compare.compare(ref, ro, port, options.support_threshold,
                           options.filter_max)
    nums["missing"] = compare.count_missing(by_name, ds, attempted)
    failed = nums["missing"] + nums["output_bad"]
    return nums, compare.verdict(nums, limits), failed


def measure(engine, options, paths, qry_info, invocation, tmp, seconds,
            trace, t_start, record):
    """Warm-up chunk, then the window (with the profiler on the card, and
    the Newton recorder when tracing); fills ``record`` and returns the
    window."""
    import torch
    from benchmark.trace import DeviceTimeline, NewtonRecorder, Profiler
    from epa_ng_tpu_torch.ops import blo_kernel
    on_card = engine.device.type == "cuda"
    recorder = prof = None
    program = program_recorder()
    if trace:
        recorder = NewtonRecorder(blo_kernel.blo_newton, engine.device)
        blo_kernel.blo_newton = recorder
    try:
        warm = writer_for(engine, options, tmp, "warm.jplace", invocation)
        Window(engine, options, paths["pool"], qry_info, warm).run(
            max_chunks=1)
        if on_card:
            torch.cuda.synchronize()
        record.setup_s = time.perf_counter() - t_start
        writer = writer_for(engine, options, tmp, "window.jplace",
                            invocation)
        win = Window(engine, options, paths["pool"], qry_info, writer)
        if on_card:
            # every run on the card traces the device: card_ms_per_kq is
            # an end-to-end metric
            prof = Profiler(recorder.stream if trace else None)
            prof.start()
        if trace:
            recorder.recording = True
        before = None if program is None else (program.totals(),
                                               program.counts())
        cpu0 = host_cpu_s()
        win.run(seconds=seconds)
        record.host = (f"host: {(host_cpu_s() - cpu0) / win.seconds:.3f} "
                       f"cores busy in this process over the window")
        if program is not None:
            after = program.totals(), program.counts()
            record.program_totals = spans_since(before[0], after[0])
            record.program_counts = counts_since(before[1], after[1])
            record.program_run_totals, record.program_run_counts = after
            record.program_spans = program.window(win.t0_ns, win.t1_ns)
        if trace:
            recorder.recording = False
        if prof is not None:
            prof.stop()
    finally:
        if recorder is not None:
            blo_kernel.blo_newton = recorder._kernel
    if on_card:
        torch.cuda.synchronize()
        record.memory = int(torch.cuda.max_memory_allocated())
    record.written, record.window_s = win.written, win.seconds
    record.spans = win.spans
    if trace:
        record.newton = recorder.totals()
    if prof is not None:
        record.timeline = DeviceTimeline(prof.events(), win.t0_ns, win.t1_ns)
    # the window keeps its counts and spans; the program's state goes
    win.engine = win.reader = win.writer = None
    return win


def run(reg, workload: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float = _T0,
        record: RunRecord | None = None) -> dict:
    """One run of a cell; returns the result (the line's object) and fills
    ``record`` when one is given."""
    import torch
    from benchmark import compare, datagen
    cfg = reg.config(workload["config"])
    mix = reg.mix(workload["traffic"])
    limits = reg.limits(workload["name"])
    on_card = device == "cuda"
    record = RunRecord() if record is None else record
    record.trace = trace
    with tempfile.TemporaryDirectory(prefix="epa_bench_") as tmp:
        ds = datagen.generate(cfg, seed)
        paths = datagen.write_files(ds, tmp)
        engine, options, qry_info, invocation, record.build_s = build_engine(
            cli_argv(cfg, mix, paths, tmp, device), device)
        win = measure(engine, options, paths, qry_info, invocation, tmp,
                      seconds, trace, t_start, record)
        # the reference runs with the program's state freed
        del engine
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            print(f"device memory held at the check: "
                  f"{torch.cuda.memory_allocated()} bytes", file=sys.stderr)
        t_check = time.perf_counter()
        nums, correct, failed = check(
            ds, cfg, options, limits, os.path.join(tmp, "window.jplace"),
            win.dispatched, seed, device)
        t_check = time.perf_counter() - t_check

    metrics = {}
    for m in reg.metrics("per_layer" if trace else "end_to_end",
                         workload["name"]):
        v = reg.reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(workload["chips"]), "memory_peak_bytes": record.memory}
    result = {"correct": bool(correct), "attempted": int(win.dispatched),
              "failed": int(failed), "metrics": metrics, "device": dev}
    tl = record.timeline
    if tl is not None:
        print(f"device: busy {tl.busy_s!r} s of the window's "
              f"{tl.window_s!r} s", file=sys.stderr)
    if trace and tl is not None:
        dev["busy_s"], dev["window_s"] = tl.busy_s, tl.window_s
        ops = sorted(tl.time_by_name().items(), key=lambda kv: -kv[1])
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in
                          tl.idle_by_host(win.spans.records)[:10]]}
        print(f"trace: {len(tl.events)} device events, the recorder's "
              f"stream {tl.side_stream}", file=sys.stderr)
    if record.newton is not None:
        print(f"newton: {json.dumps(record.newton)}", file=sys.stderr)
    print(record.host, file=sys.stderr)
    print(f"window: {win.written} reads in {win.seconds:.4f} s, "
          f"{win.passes} passes of the pool; set-up {record.setup_s:.4f} s "
          f"(build {record.build_s:.4f} s); check {t_check:.4f} s", file=sys.stderr)
    ends = sorted(e for n, _, e in win.spans.records if n == "emit")
    if len(ends) > 6:
        thirds = [ends[len(ends) * i // 3] for i in range(3)] + [ends[-1]]
        print("emit rate by thirds of the window (chunks/s): " + " ".join(
            f"{(len(ends) // 3) / ((b - a) / 1e9):.3f}"
            for a, b in zip(thirds, thirds[1:])), file=sys.stderr)
    result["checks"] = {k: {"value": nums[k], "limit": limits[k]}
                        for k in compare.NUMBERS}
    return result


def host_cpu_s() -> float:
    """This process's CPU seconds (user and system) so far."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def silent_metrics(reg, workload: dict, result: dict,
                   record: RunRecord) -> tuple:
    """(absent, silent): the metrics of the cell that this run left out of
    its result. Absent: the reader names a span or count that the program
    never recorded in the whole run, warm-up included, or the program has
    no recorder; the program does not yet have what the metric measures
    (an older program, such as a change's parent). Silent: every other
    one; the program no longer runs what the harness instruments."""
    kind = "per_layer" if record.trace else "end_to_end"
    spans = record.program_run_totals
    counts = record.program_run_counts
    absent, silent = [], []
    for m in reg.metrics(kind, workload["name"]):
        if m["name"] in result["metrics"]:
            continue
        want_spans, want_counts = reg.program_names(m["name"])
        lacking = (want_spans or want_counts) and (
            spans is None or not set(want_spans) <= set(spans)
            or not set(want_counts) <= set(counts))
        (absent if lacking else silent).append(m["name"])
    return absent, silent


def finish(reg, workload: dict, result: dict, record: RunRecord) -> int:
    """Judge what the run left out and what it loaded, and print the result
    line when nothing stops it; returns the exit code."""
    absent, silent = silent_metrics(reg, workload, result, record)
    if absent:
        print(f"metrics absent from this program: {absent}", file=sys.stderr)
    if silent:
        # the cell lists these metrics and the program records what they
        # read: one that reads nothing means the program no longer runs
        # what the harness instruments
        print(f"metrics of this cell that read nothing: {silent}",
              file=sys.stderr)
        return 4
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch
    from benchmark.registry import Registry
    reg = Registry()
    workload = reg.workload(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < workload["chips"]):
        print(f"{args.workload} needs {workload['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    record = RunRecord()
    result = run(reg, workload, args.seed, args.seconds, bool(args.trace),
                 record=record)
    print(f"card: {card_line()}", file=sys.stderr)
    return finish(reg, workload, result, record)


if __name__ == "__main__":
    sys.exit(main())

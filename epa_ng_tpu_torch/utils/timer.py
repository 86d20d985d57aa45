"""The placement pipeline's span recorder: one per process, always on.

A span is one stage of one chunk on one thread: its name, the span it
nests in, the chunk it belongs to (nested spans take their parent's), the
thread's name, its start and end on ``time.time_ns()`` (the clock that
``torch.profiler``'s device events are compared on) and the thread's CPU
time over it (``time.thread_time_ns()``). Wall time less CPU time is the
time the thread waited: on a queue, on the device, on I/O or on the
interpreter lock.

Spans sit at chunk granularity only (a handful a chunk, microseconds
each against the chunk's milliseconds), so the recorder has no switch: a
switch would have to be turned on by every reader of the spans, and the
benchmark's harness (``benchmark/run.py``) drives the pipeline as the CLI
does, with no such setting. The last ``RING`` spans stay in memory, with
a count of those the ring dropped; running totals by name (count, wall,
CPU) never drop, so a long job's totals do not depend on the ring.
``cli.LAST_RUN_STATS`` and the CLI's stage line read the totals; a reader
of the spans over a stretch of time (a traced run's window) takes them
with :meth:`SpanRecorder.window`, which says when the ring dropped some.

Beside the spans the recorder keeps running counts by name
(:meth:`SpanRecorder.count`), which never drop either: how often a stage
took one path or another (the reader's ``read.rows_gather`` and
``read.rows_byteloop``, ``collapse.exact``), read with
:meth:`SpanRecorder.counts`.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple, Optional

RING = 1 << 16


class Span(NamedTuple):
    id: int
    name: str
    parent: Optional[int]   # id of the span this one nests in
    chunk: Optional[int]    # the pipeline's chunk index; None outside it
    thread: str
    start_ns: int
    end_ns: int
    cpu_ns: int             # the thread's CPU time over the span

    @property
    def wall_ns(self) -> int:
        return self.end_ns - self.start_ns


class _Open:
    """One span while it runs (the recorder's context manager)."""

    __slots__ = ("_rec", "_name", "_chunk", "_id", "_parent", "_t0", "_c0")

    def __init__(self, rec: "SpanRecorder", name: str, chunk):
        self._rec, self._name, self._chunk = rec, name, chunk

    def __enter__(self):
        rec = self._rec
        stack = rec._stack()
        self._parent = None
        if stack:
            up = stack[-1]
            self._parent = up._id
            if self._chunk is None:
                self._chunk = up._chunk
        self._id = next(rec._ids)
        stack.append(self)
        self._c0 = time.thread_time_ns()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        c1 = time.thread_time_ns()
        rec = self._rec
        rec._stack().pop()
        rec._add(Span(self._id, self._name, self._parent, self._chunk,
                      threading.current_thread().name, self._t0, t1,
                      c1 - self._c0))
        return False


class SpanRecorder:
    def __init__(self, capacity: int = RING):
        self.capacity = capacity
        self._ring: list = [None] * capacity
        self._n = 0                     # spans ever recorded
        self._dropped_end = -1          # latest end of a dropped span
        self._totals: dict = {}         # name -> [count, wall_ns, cpu_ns]
        self._counts: dict = {}         # name -> running count
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._local = threading.local()

    def span(self, name: str, chunk: Optional[int] = None) -> _Open:
        """``with recorder.span("read", chunk=i): ...``"""
        return _Open(self, name, chunk)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _add(self, s: Span):
        with self._lock:
            i = self._n % self.capacity
            old = self._ring[i]
            if old is not None and old.end_ns > self._dropped_end:
                self._dropped_end = old.end_ns
            self._ring[i] = s
            self._n += 1
            t = self._totals.get(s.name)
            if t is None:
                t = self._totals[s.name] = [0, 0, 0]
            t[0] += 1
            t[1] += s.wall_ns
            t[2] += s.cpu_ns

    @property
    def dropped(self) -> int:
        """Spans the ring let go of."""
        with self._lock:
            return max(0, self._n - self.capacity)

    def spans(self) -> list:
        """The ring's spans, in the order they ended."""
        with self._lock:
            n, cap = self._n, self.capacity
            if n <= cap:
                return self._ring[:n]
            i = n % cap
            return self._ring[i:] + self._ring[:i]

    def window(self, t0_ns: int, t1_ns: int) -> Optional[list]:
        """The spans that overlap [t0_ns, t1_ns], or None when the ring
        dropped one that may have."""
        with self._lock:
            if self._dropped_end > t0_ns:
                return None
        return [s for s in self.spans()
                if s.end_ns > t0_ns and s.start_ns < t1_ns]

    def count(self, name: str, n: int = 1):
        """Add ``n`` to the running count ``name``."""
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def counts(self) -> dict:
        """name -> every running count so far."""
        with self._lock:
            return dict(self._counts)

    def totals(self) -> dict:
        """name -> (count, wall seconds, CPU seconds) of every span so far."""
        with self._lock:
            return {k: (c, w / 1e9, u / 1e9)
                    for k, (c, w, u) in self._totals.items()}


RECORDER = SpanRecorder()
span = RECORDER.span


def since(before: dict, after: dict) -> dict:
    """The totals of the spans between two ``totals()`` readings."""
    out = {}
    for k, (c, w, u) in after.items():
        c0, w0, u0 = before.get(k, (0, 0.0, 0.0))
        if c > c0:
            out[k] = (c - c0, w - w0, u - u0)
    return out


def counts_since(before: dict, after: dict) -> dict:
    """The running counts between two ``counts()`` readings."""
    return {k: n - before.get(k, 0) for k, n in after.items()}

"""Asynchronous streaming pipeline: overlap host IO with device compute.

Replaces the reference's __PREFETCH machinery (async next-chunk reads,
src/seq/MSA_Stream.cpp:63-88, and async jplace chunk writes,
src/io/jplace_writer.hpp:58-69) and is the wired-in successor of its
typed-stage Pipeline (src/pipeline/Pipeline.hpp — present but unwired in the
reference's main path):

    reader thread -> [chunk queue] -> compute (device) -> [result queue]
    -> writer thread

Each stage records a span a chunk in the process' recorder
(``utils/timer.py``): ``read`` on the reader thread, ``wait_chunk`` (the
dispatching thread waiting for a read chunk), ``dispatch`` and
``wait_writer`` (waiting for room in the result queue) on the thread that
calls :meth:`StreamingPipeline.run`, and ``write`` on the writer thread;
the spans that ``read``, ``dispatch`` and ``write`` call open nest in
them and share their chunk index.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Callable, Optional

from epa_ng_tpu_torch.utils.timer import span

_END = object()


class StreamingPipeline:
    """Three-stage streaming pipeline with bounded prefetch queues."""

    def __init__(self, read_chunk: Callable[[], Optional[object]],
                 compute: Callable[[object, int], object],
                 write: Callable[[object], None],
                 prefetch: int = 2):
        """read_chunk() -> chunk or None at end; compute(chunk, index) ->
        result; write(result)."""
        self._read = read_chunk
        self._compute = compute
        self._write = write
        self._in_q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._out_q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._error: Optional[BaseException] = None

    def _reader(self):
        try:
            for n in itertools.count():
                with span("read", n):
                    chunk = self._read()
                if chunk is None:
                    break
                self._in_q.put(chunk)
        except BaseException as e:  # propagate to the main thread
            self._error = e
        finally:
            self._in_q.put(_END)

    def _writer(self):
        try:
            while True:
                item = self._out_q.get()
                if item is _END:
                    break
                n, result = item
                with span("write", n):
                    self._write(result)
        except BaseException as e:
            self._error = e
            # drain so the producer never blocks
            while self._out_q.get() is not _END:
                pass

    def run(self) -> int:
        """Run to completion; returns the number of chunks processed."""
        rt = threading.Thread(target=self._reader, daemon=True,
                              name="pipeline-reader")
        wt = threading.Thread(target=self._writer, daemon=True,
                              name="pipeline-writer")
        rt.start()
        wt.start()
        n = 0
        try:
            while True:
                with span("wait_chunk", n):
                    chunk = self._in_q.get()
                if chunk is _END:
                    break
                with span("dispatch", n):
                    result = self._compute(chunk, n)
                with span("wait_writer", n):
                    self._out_q.put((n, result))
                n += 1
                if self._error:
                    break
        finally:
            self._out_q.put(_END)
            wt.join()
            rt.join(timeout=5)
        if self._error:
            raise self._error
        return n

"""newton_ms_per_kq: device milliseconds of the Newton kernel
(csrc/blo_newton.cu) a 1,000 reads written, from the profiler's trace."""

from benchmark.trace import NEWTON_KERNEL


def read(run):
    if run.timeline is None or not run.written:
        return None
    s = run.timeline.seconds(NEWTON_KERNEL)
    return s * 1e6 / run.written if s > 0 else None

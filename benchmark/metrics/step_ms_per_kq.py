"""step_ms_per_kq: device milliseconds a 1,000 reads written of every
device operation but the Newton kernel (the fused step's scoring, top-k,
gathers, copies), from the profiler's trace."""

from benchmark.trace import NEWTON_KERNEL


def read(run):
    if run.timeline is None or not run.written:
        return None
    s = run.timeline.seconds(NEWTON_KERNEL, invert=True)
    return s * 1e6 / run.written if s > 0 else None

"""newton_roofline_pct: the Newton kernel's share of its roofline: the
summed per-launch bound (benchmark/counts.py: the larger of operations over
the float32 peak and bytes over HBM bandwidth, from the pairs' windows,
each input byte once a launch, and the kernel's own smoothing and
iteration counters) over its device time in the trace."""

from benchmark.trace import NEWTON_KERNEL


def read(run):
    if run.timeline is None or run.newton is None:
        return None
    s = run.timeline.seconds(NEWTON_KERNEL)
    if s <= 0 or not run.newton["launches"]:
        return None
    return 100.0 * run.newton["bound_s"] / s

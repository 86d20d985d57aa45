"""device_idle_pct: the window less the union of its device intervals,
over the window, from the profiler's timeline."""


def read(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)

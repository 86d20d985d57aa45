"""qps: reads whose jplace entries were written, over the window (host
clock), under the dynamic heuristic."""


def read(run):
    return run.rate

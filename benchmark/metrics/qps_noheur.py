"""qps_noheur: reads whose jplace entries were written, over the window
(host clock), under --no-heur."""


def read(run):
    return run.rate

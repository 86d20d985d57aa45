"""read_us_per_q: the harness's span around reading, encoding and
collapsing a chunk (the reader thread), microseconds a read written."""


def read(run):
    return run.span_us_per_query("read")

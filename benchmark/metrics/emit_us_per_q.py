"""emit_us_per_q: the harness's span around JplaceWriter.write (and the
closing write), microseconds a read written."""


def read(run):
    return run.span_us_per_query("emit")

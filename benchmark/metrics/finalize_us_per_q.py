"""finalize_us_per_q: the harness's span around
PlacementEngine.finalize_chunk (sync, assembly, LWR, filter; under
--no-heur the whole exact path), microseconds a read written."""


def read(run):
    return run.span_us_per_query("finalize")

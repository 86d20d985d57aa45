"""dispatch_us_per_q: the harness's span around
PlacementEngine.place_encoded_async, microseconds a read written."""


def read(run):
    return run.span_us_per_query("dispatch")

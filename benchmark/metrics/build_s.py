"""build_s: the engine's constructor (eigen system, CLVs, lookup table,
sumtable store): the harness's span around it."""


def read(run):
    return run.build_s

"""emit_cpu_us_per_q: the program's own span ``emit`` (io/jplace.py,
JplaceWriter.write and close: the jplace formatting): the writing thread's
CPU microseconds over the window, a read written."""

SPANS = ("emit",)


def read(run):
    return run.program_cpu_us_per_query("emit")

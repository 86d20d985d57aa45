"""read_cpu_us_per_q: the program's own span ``read`` (core/pipeline.py,
around reading, encoding and collapsing a chunk on the reader thread):
that thread's CPU microseconds over the window, a read written."""

SPANS = ("read",)


def read(run):
    return run.program_cpu_us_per_query("read")

"""dispatch_cpu_us_per_q: the program's own span ``dispatch``
(core/pipeline.py, around the engine's dispatch of a chunk on the thread
that runs the pipeline): that thread's CPU microseconds over the window, a
read written. Its wall (dispatch_us_per_q) less this is the time the
thread waited, most of it for the interpreter lock."""

SPANS = ("dispatch",)


def read(run):
    return run.program_cpu_us_per_query("dispatch")

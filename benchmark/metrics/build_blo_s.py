"""build_blo_s: the program's own span ``build.blo`` (core/engine.py,
around the eigen-transformed sumtable store's build,
``newton.transform_edges``; closed after a device sync on the card): its
wall seconds over the whole run."""

SPANS = ("build.blo",)


def read(run):
    t = (run.program_run_totals or {}).get("build.blo")
    return None if t is None else t[1]

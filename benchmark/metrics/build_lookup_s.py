"""build_lookup_s: the program's own span ``build.lookup``
(core/engine.py, around the preplacement lookup table's build; on the card
it closes after a device sync, so its wall time is the build's device
time): its wall seconds over the whole run (the build precedes the
window)."""

SPANS = ("build.lookup",)


def read(run):
    t = (run.program_run_totals or {}).get("build.lookup")
    return None if t is None else t[1]

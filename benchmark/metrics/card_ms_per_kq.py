"""card_ms_per_kq: the card's busy milliseconds a 1,000 reads written, over
the window: the union of the device's operations in the window (the
profiler's timeline, which every run on the card takes), over every read
written. The card time that placing a read costs, whatever the host does
while the card waits."""


def read(run):
    tl = run.timeline
    if tl is None or not run.written or tl.busy_s <= 0:
        return None
    return tl.busy_s * 1e6 / run.written

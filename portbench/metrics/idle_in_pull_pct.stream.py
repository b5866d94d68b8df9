"""Share of ``step_idle_pct.stream``'s idle time during which the server's
thread was inside ``serving.pull``, waiting for the cameras: the idle
stretches, put on the host clock through the program's anchor, against the
host intervals of the window's ``serving.pull`` spans. Read on the card
only."""

from portbench import program_trace as pt


def read(run):
    got = pt.idle_gaps(run)
    if got is None:
        return None
    _, gaps, _ = got
    total = sum(b - a for a, b in gaps)
    if total <= 0:
        return None
    pulls = [d["serving.pull"] for d in pt.steps(run) if "serving.pull" in d]
    return 100.0 * pt.overlap_ns(gaps, pulls) / total

"""Share of the device's time with no step's work on the compute stream:
from each step's results-ready event to the next step's first work (the
start event of its ``serving.launch``), where that is positive, over the
time from the first step's start to the last step's results, on the
program's events of the window's steps before the profiler starts (no
profiler slows the host here). Read on the card only."""

from portbench import program_trace as pt


def read(run):
    got = pt.idle_gaps(run)
    if got is None or got[0] <= 0:
        return None
    total, _, idle = got
    return 100.0 * idle / total

"""``serving.StreamServer``'s time per step: the median, over the window's
steps before the profiler starts, of the host time from the step's last
frame being pulled to its results being handed out (which the server does
after it has pulled and launched the next step)."""

import statistics


def read(run):
    n = min(run.n_window, len(run.handed), len(run.pulled))
    gaps = [(run.handed[k] - run.pulled[k]) * 1e3 for k in range(n)
            if run.handed[k] < run.stretch.t_on]
    return statistics.median(gaps) if gaps else None

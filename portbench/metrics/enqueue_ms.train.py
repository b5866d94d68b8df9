"""Host milliseconds to enqueue one training step: the host clock around
each step call in the traced run's window before the profiler
starts (it slows the host), mean."""


def read(run):
    ms = run.spans.host_ms("train.step", run.stretch.t_on)
    return sum(ms) / len(ms) if ms else None

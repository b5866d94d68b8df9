"""Host milliseconds to enqueue one step (one frame of every stream): the
host clock around each ``InferencePipeline.forward_device`` call in the traced run's window
before the profiler starts (it slows the host), mean."""


def read(run):
    ms = run.spans.host_ms("forward_device", run.stretch.t_on)
    return sum(ms) / len(ms) if ms else None

"""Host milliseconds to enqueue one step's synthesised batch
(``DeviceSynthesizer.batch`` inside the step's dispatch): the host clock
around each call in the traced run's window before the profiler starts,
mean."""


def read(run):
    ms = run.spans.host_ms("portbench.synth", run.stretch.t_on)
    return sum(ms) / len(ms) if ms else None

"""Device milliseconds per batch of the assignment and the mutual filter (the
program's ``match.assign`` span): the kernels the profiler puts inside
that span's ranges over the profiled stretch, divided by the ranges there.
None where the program has no such span."""


def read(run):
    got = run.stretch.device_ms_of("match.assign")
    return got[0] / got[1] if got else None

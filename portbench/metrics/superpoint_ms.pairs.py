"""Device milliseconds per batch of SuperPoint's network (the program's
``match.superpoint`` span): the kernels the profiler puts inside that
span's ranges over the profiled stretch, divided by the ranges there. None
where the program has no such span."""


def read(run):
    got = run.stretch.device_ms_of("match.superpoint")
    return got[0] / got[1] if got else None

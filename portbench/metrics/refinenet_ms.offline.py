"""Device milliseconds of ``models.RefineNet`` per batch: the kernels the
profiler attributes to RefineNet's span (its forward hooks) over the
profiled stretch, divided by its calls there."""


def read(run):
    got = run.stretch.device_ms_of("refinenet")
    return got[0] / got[1] if got else None

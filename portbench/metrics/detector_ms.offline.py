"""Device milliseconds of ``models.Detector`` per batch: the kernels the
profiler attributes to the detector's span (its forward hooks) over the
profiled stretch, divided by the detector's calls there."""


def read(run):
    got = run.stretch.device_ms_of("detector")
    return got[0] / got[1] if got else None

"""Device milliseconds of one step's synthesised batch: the kernels the
profiler attributes to the benchmark's span around each
``DeviceSynthesizer.batch`` call over the profiled stretch, divided by
the calls there (synthesis runs on the main thread, in the span's
range)."""


def read(run):
    got = run.stretch.device_ms_of("portbench.synth")
    return got[0] / got[1] if got else None

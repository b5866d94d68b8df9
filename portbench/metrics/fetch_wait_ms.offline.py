"""The host's headroom per batch: the program's ``serving.fetch`` span (the
host blocked until a batch's results are on the host), mean over the
window's batches before the profiler starts. Higher is better: the host
waits for the device, not the device for the host."""

from portbench import program_trace as pt


def read(run):
    return pt.mean(pt.child_ms(run, "serving.fetch"))

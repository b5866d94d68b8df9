"""Device milliseconds of the pose tail per batch: the CUDA events of the
program's ``pipeline.pose`` span (the copy into the CUDA graph's inputs and
its replay), mean over the window's batches before the profiler starts.
Read on the card only."""

from portbench import program_trace as pt


def read(run):
    if not pt.prepare(run):
        return None
    return pt.mean(s.device_ms() for s in pt.window(run, "pipeline.pose")
                   if s.ev0 is not None)

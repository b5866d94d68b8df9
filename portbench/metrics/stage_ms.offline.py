"""Host milliseconds to stage one batch: the program's ``serving.stage``
span (the wait for a pinned staging buffer, the gather of the frames into
it and the upload's enqueue), mean over the window's batches before the
profiler starts."""

from portbench import program_trace as pt


def read(run):
    return pt.mean(pt.child_ms(run, "serving.stage"))

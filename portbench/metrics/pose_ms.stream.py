"""Device milliseconds of the pose tail per step: CUDA events recorded on
the compute stream around each ``InferencePipeline.solve_pose`` call (the
copy into the CUDA graph's inputs and its replay), mean over the steps
before the profiler starts.
The profiler does not attribute a graph replay's kernels to a range."""


def read(run):
    ms = run.spans.event_ms("solve_pose", run.stretch.t_on)
    return sum(ms) / len(ms) if ms else None

"""Device milliseconds of one training step (``train.steps``): CUDA events
recorded on the stream around each step call, mean over the steps before
the profiler starts. The backward pass launches its kernels from
autograd's own thread, outside the step's profiler range, so the range
cannot attribute them."""


def read(run):
    ms = run.spans.event_ms("train.step", run.stretch.t_on)
    return sum(ms) / len(ms) if ms else None

"""Host milliseconds of the backward pass per training step: the program's
``train.backward`` span (the host blocked while autograd's thread enqueues
the backward pass), mean over the window's steps before the profiler
starts."""

from portbench import program_trace as pt


def read(run):
    return pt.mean(pt.host_ms(run, "train.backward"))

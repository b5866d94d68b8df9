"""Host milliseconds to enqueue Adam's update per training step: the
program's ``train.update`` span, mean over the window's steps before the
profiler starts."""

from portbench import program_trace as pt


def read(run):
    return pt.mean(pt.host_ms(run, "train.update"))

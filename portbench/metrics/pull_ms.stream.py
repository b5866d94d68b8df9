"""``serving.StreamServer``'s wait for its frames: the program's
``serving.pull`` span of each step (one frame from every camera, each
camera sleeping until its frame is due), median over the window's steps
before the profiler starts."""

from portbench import program_trace as pt


def read(run):
    return pt.median(pt.child_ms(run, "serving.pull"))

"""How long a step's finished results wait on the host before they are
handed out: from the step's results-ready event (the download's CUDA event,
put on the host clock through the program's anchor) to the end of its
``serving.step`` span, median over the window's steps before the profiler
starts. The server launches step k+1, which waits for its cameras, before
it hands out step k. Read on the card only."""

from portbench import program_trace as pt


def read(run):
    return pt.median(pt.held_ms(run))

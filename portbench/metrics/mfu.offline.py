"""The whole pipeline's share of the card's bfloat16 peak: the program
module's analytic FLOPs of one frame (``flops_per_item(cfg, "serve")``:
the detector and RefineNet on every slot) times the traced run's frames
per second before the profiler starts, over 989 TFLOP/s. Read on the card
only."""

from portbench import counts


def read(run):
    if run.device.type != "cuda":
        return None
    fps = run.rate_before_trace(run.done_at, run.p["batch"])
    if fps is None:
        return None
    return (100.0 * run.prog.flops_per_item(run.cfg, "serve") * fps
            / counts.PEAK_FLOPS[run.cfg["compute_dtype"]])

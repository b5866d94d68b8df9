"""The whole pipeline's share of the card's bfloat16 peak: the analytic
FLOPs of one frame (``counts.frame_flops``: the detector and RefineNet on
every slot) times the traced run's frames per second before the profiler starts,
over 989 TFLOP/s. Read on the card only."""

from portbench import counts


def read(run):
    if run.device.type != "cuda":
        return None
    fps = run.rate_before_trace(run.done_at, run.p["batch"])
    if fps is None:
        return None
    return 100.0 * counts.frame_flops(run.cfg) * fps / counts.PEAK_FLOPS[run.cfg["compute_dtype"]]

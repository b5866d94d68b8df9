"""The training step's share of the card's TF32 peak (the precision of the
cell's convolutions): the program module's analytic forward and backward
FLOPs per sample (``flops_per_item(cfg, "train")``) times the traced run's
samples per second before the profiler starts, over 495 TFLOP/s. Read on
the card only."""

from portbench import counts


def read(run):
    if run.device.type != "cuda":
        return None
    rate = run.rate_before_trace(run.launched_at, run.p["batch"])
    if rate is None:
        return None
    key = "tf32" if run.cfg["train"]["conv_tf32"] else run.cfg["train"]["param_dtype"]
    return 100.0 * run.prog.flops_per_item(run.cfg, "train") * rate / counts.PEAK_FLOPS[key]

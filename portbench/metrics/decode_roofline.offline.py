"""B1's share of its roofline (``csrc/decode.cu``): the least time of one
launch on one batch (its logits read once and its corners written once,
the program module's ``decode_min_seconds``, over the card's bandwidth)
divided by the mean time of a ``decode_kernel`` launch in the profiled
stretch."""


def read(run):
    got = run.stretch.kernel_ms("decode_kernel", unless="fused")
    if not got:
        return None
    per_launch_s = got[0] / got[1] / 1e3
    return 100.0 * run.prog.decode_min_seconds(run.cfg, run.p["batch"]) / per_launch_s

"""Attention's share of the card's bfloat16 peak: the attention FLOPs the
model defines for the profiled batches (the program module's
``attention_flops`` a pair: per layer each image's self attention and the
cross block's one similarity and two weighted sums, every keypoint slot
counted), over the device time of the kernels inside the program's
``match.attention`` ranges that lie in those batches' ``match.lightglue``
ranges, over 989 TFLOP/s. None where the program has no such spans."""

import bisect

from portbench import counts


def read(run):
    ranges = run.stretch.ranges
    batches, calls = ranges.get("match.lightglue"), ranges.get("match.attention")
    if not batches or not calls:
        return None
    ops = run.stretch.ops
    starts = [a for _, a, _ in ops]
    us = 0.0
    for lo, hi in calls:
        if any(b0 <= lo and hi <= b1 for b0, b1 in batches):
            us += sum(b - a for n, a, b in ops[bisect.bisect_left(starts, lo):
                                               bisect.bisect_right(starts, hi)]
                      if not n.startswith(("Memcpy", "Memset")))
    if us <= 0:
        return None
    flops = run.prog.attention_flops(run.cfg) * (run.p["batch"] // 2) * len(batches)
    return 100.0 * flops / (us / 1e6) / counts.PEAK_FLOPS[run.cfg["compute_dtype"]]

"""The one sweep that fixes the stream cell's camera count, on the card:

    python -m portbench.sweep_streams --workload base_stream_pose \
        [--start 8 --stop 160 --step 8 --seconds 8]

For each S (multiples of 8) it runs the cell's stream mix with S cameras for
``--seconds``, ``REPEATS`` times on seeds of their own, and prints for
each run the latency's median and 95th percentile, the frames that never
came back, and the backlog: the growth of the latency's median from the
first quarter of the window's steps to the last. S is sustained where every
run's 95th percentile stays within two frame intervals (66.7 ms at 30 fps)
with no growing backlog (under one frame interval of growth). The knee is
the highest sustained S; the cell runs at 4/5 of it, rounded down to a
multiple of 8. The sweep stops after two camera counts beyond the knee.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from portbench import harness
from portbench.drivers.stream import Run

REPEATS = 3


def point(name: str, streams: int, seconds: float, seed: int, device) -> dict:
    c = harness.cell(name)
    c["params"]["streams"] = streams
    run = Run(c, seed, seconds, False, device, None)
    run.setup()
    run.window()
    run.release()
    per_step = [(run.handed[k] - run.due(k)) * 1e3
                for k in range(min(run.n_window, len(run.handed)))]
    q = max(1, len(per_step) // 4)
    return {"streams": streams, "p50_ms": statistics.median(run.latency_ms),
            "p95_ms": float(np.percentile(run.latency_ms, 95)),
            "failed": run.failed, "attempted": run.attempted,
            "backlog_ms": statistics.median(per_step[-q:]) - statistics.median(per_step[:q])}


def main(argv=None) -> int:
    harness.cache_dirs()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="base_stream_pose")
    ap.add_argument("--start", type=int, default=8)
    ap.add_argument("--stop", type=int, default=160)
    ap.add_argument("--step", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=3_500_000_000)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    fps = harness.cell(args.workload)["params"]["fps"]
    limit = 2e3 / fps
    knee, beyond = None, 0
    for s in range(args.start, args.stop + 1, args.step):
        sustained = True
        for r in range(REPEATS):
            row = point(args.workload, s, args.seconds, args.seed + 1009 * r, device)
            row["sustained"] = (row["p95_ms"] <= limit and row["backlog_ms"] < 1e3 / fps
                                and row["failed"] == 0)
            sustained &= row["sustained"]
            print(json.dumps(row), flush=True)
        if sustained:
            knee, beyond = s, 0
        else:
            beyond += 1
            if beyond == 2:
                break
    chosen = None if knee is None else max(8, int(0.8 * knee) // 8 * 8)
    print(json.dumps({"knee": knee, "streams": chosen, "limit_ms": limit,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

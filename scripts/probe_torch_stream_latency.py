"""Where a live-camera step's latency goes: one run of the stream cell's
window (``portbench.drivers.stream``: its cameras and frames, no
comparison), then each step's parts from the port's own spans.

    python scripts/probe_torch_stream_latency.py SEED [SECONDS] [CAMERAS]

on the card, from the repository's root (the cell's 40 s and 56 cameras by
default). Prints one JSON line: percentiles (50, 90, 95, 99, 100) in ms of
each part, due time → frames pulled (``serving.pull``'s end), pulled →
staging starts, ``serving.stage``, ``serving.launch``, launch's end →
results ready (the download's event on the host clock), ready → handed
out (``serving.step``'s end), ``serving.fetch``, handed out → the
consumer holds it, and the latency itself; the mean of each part over the
slowest 5% of steps; ``serving.launched_ahead`` in the window; and the
garbage collector's passes (count, longest ms) per generation.
"""

import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deepcharuco_tpu_torch import profiling  # noqa: E402
from portbench import harness  # noqa: E402
from portbench.drivers.stream import Run  # noqa: E402

PARTS = ("due_to_pulled", "pulled_to_stage", "stage", "launch", "launch_to_ready",
         "ready_to_handed", "fetch", "handed_to_consumer", "latency")


def percentiles(v):
    return {p: round(float(np.percentile(v, p)), 3) for p in (50, 90, 95, 99, 100)}


def main(argv):
    harness.cache_dirs()
    seed = int(argv[0])
    seconds = float(argv[1]) if len(argv) > 1 else 40.0
    device = torch.device("cuda", 0)
    cell = harness.cell("base_stream_pose")
    if len(argv) > 2:
        cell["params"]["streams"] = int(argv[2])
    passes = []

    def on_gc(phase, info):
        if phase == "start":
            on_gc.t = time.perf_counter()
        else:
            passes.append((info["generation"], (time.perf_counter() - on_gc.t) * 1e3))

    gc.callbacks.append(on_gc)
    run = Run(cell, seed, seconds, False, device, None)
    run.setup()
    before = profiling.counters()
    run.window()
    torch.cuda.synchronize(device)
    profiling.anchor(device, again=True)      # the events of the window onto the host clock
    ahead = (profiling.counters().get("serving.launched_ahead", 0)
             - before.get("serving.launched_ahead", 0))
    lo, hi = run.t_start * 1e9, run.t_end * 1e9
    held = profiling.spans()
    steps = {id(s): {"serving.step": s} for s in held
             if s.name == "serving.step" and s.t0 >= lo and s.t1 <= hi}
    for s in held:
        if s.parent is not None and id(s.parent) in steps:
            steps[id(s.parent)][s.name] = s
    rows = {name: [] for name in PARTS}
    for d in steps.values():
        k = d["serving.step"].step
        if ("serving.launch" not in d or k >= len(run.handed)
                or run.due(k) >= run.t0 + run.seconds):
            continue
        pull, stage, launch = d["serving.pull"], d["serving.stage"], d["serving.launch"]
        fetch, step = d["serving.fetch"], d["serving.step"]
        ready = profiling.host_ns(step.ev1, device)
        for name, ms in zip(PARTS, (
                (pull.t1 - run.due(k) * 1e9) / 1e6, (stage.t0 - pull.t1) / 1e6,
                stage.host_ms(), launch.host_ms(), (ready - launch.t1) / 1e6,
                (step.t1 - ready) / 1e6, fetch.host_ms(),
                (run.handed[k] * 1e9 - step.t1) / 1e6, (run.handed[k] - run.due(k)) * 1e3)):
            rows[name].append(ms)
    latency = np.array(rows["latency"])
    slow = np.argsort(latency)[-max(1, len(latency) // 20):]
    out = {"seed": seed, "cameras": run.S, "steps": len(latency),
           "latency_p95_ms": run.e2e["latency_p95_ms"], "launched_ahead": ahead,
           "gc": {g: [sum(1 for x in passes if x[0] == g),
                      round(max([x[1] for x in passes if x[0] == g] or [0]), 3)]
                  for g in (0, 1, 2)},
           "device": torch.cuda.get_device_name(device)}
    out.update({name: percentiles(v) for name, v in rows.items()})
    out["slowest_5pct_mean"] = {name: round(float(np.mean(np.array(v)[slow])), 3)
                                for name, v in rows.items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

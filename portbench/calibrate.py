"""The readings that a cell's limits are set from, in one process on the
card: sound runs of the program on many seeds (short windows), the
control on a few (the reference in the program's place, one precision
below the configuration's), and planted faults. Prints one JSON line per
run and a summary: the largest sound reading and the smallest control
reading of each number.

    python -m portbench.calibrate --workload base_offline_pose --seeds 12 \
        --control-seeds 3 --seconds 2 [--faults wrong_rows,half_batch]

The control of an inference cell runs the reference's networks with their
convolutions' inputs and kernels rounded to float8 e4m3 (per-tensor scale)
and solves the pose in bfloat16, in batches of the cell's size; that of the
training cell runs the reference's steps with convolutions rounded to
bfloat16 (the configuration trains in float32 with TF32 convolutions).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import frames, harness, program
from portbench.common import full_float32, sample_rows
from portbench.reference import nets
from portbench.reference import train as ref_train
from portbench.reference.pipeline import Reference

BASE_SEED = 3_000_000_000


def control_inference(c: dict, seed: int, device) -> dict:
    """The readings of the control on the frames a run of ``seed`` judges."""
    cfg, p = c["config"], c["params"]
    if c["driver"] == "offline":
        pool = frames.batch_pool(seed, cfg["input_hw"], p["batch"], p["pool_batches"], p)
        n_batches = max(1, -(-p["check_frames"] // p["batch"]))
        picks = sample_rows(seed, n_batches, p["batch"], p["check_frames"])
        sample = np.stack([pool[b % len(pool)][r] for b, r in picks])
        block = p["batch"]
    else:
        pool = frames.frame_pool(seed, cfg["input_hw"], p["pool_frames"], p)
        s = p["streams"]
        stride = len(pool) // s
        picks = sample_rows(seed, max(1, -(-p["check_frames"] // s)) * 4, s, p["check_frames"])
        sample = np.stack([pool[(cc * stride + k) % len(pool)] for k, cc in picks])
        block = s
    ref = Reference(cfg, harness.ROOT, device)
    with full_float32():
        out = ref.run(sample, q=nets.fp8, pose_dtype=torch.bfloat16, block=block)
        return ref.judge(sample, out)


def control_train(c: dict, seed: int, device) -> dict:
    cfg, p = c["config"], c["params"]
    t = cfg["train"]
    start = program.initial_detector(cfg, seed, device)
    host = frames.training_batches(seed, cfg["input_hw"], cfg["n_ids"], p["batch"],
                                   p["pool_batches"], p)
    checked = [tuple(torch.from_numpy(a).to(device) for a in host[i])
               for i in range(p["checked_steps"])]
    names = [k for k in start if not k.endswith(("running_mean", "running_var",
                                                 "num_batches_tracked"))]
    start = {k: start[k] for k in names}
    with full_float32():
        ref = ref_train.steps(start, checked, t["lr"], t["betas"], t["eps"])
        ctl = ref_train.steps(start, checked, t["lr"], t["betas"], t["eps"], q=nets.bf16)
    record = {"start": start, "losses": ctl[0], "grad": ctl[1], "end": ctl[2]}
    return ref_train.judge(record, {"losses": ref[0], "grad": ref[1], "end": ref[2]})


def emit(rows: list, row: dict) -> None:
    rows.append(row)
    print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    harness.cache_dirs()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=BASE_SEED)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    c = harness.cell(args.workload)
    rows: list = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.time()
        r, run, readings = harness.run_once(args.workload, seed, args.seconds, False,
                                            device=device)
        emit(rows, {"kind": "program", "seed": seed, "correct": r["correct"],
                    "readings": readings,
                    "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                    "s": time.time() - t0})
        if c["driver"] == "train_step" and i < 2:
            ref = run.reference()
            gaps = ref_train.leaf_gaps(run.record["grad"], ref["grad"], list(ref["grad"]))
            print(json.dumps({"worst_grad_leaves": sorted(gaps.items(), key=lambda kv: -kv[1])[:4],
                              "program_losses": run.record["losses"],
                              "reference_losses": ref["losses"]}), flush=True)
    for i in range(args.control_seeds):
        seed = args.first_seed + 7919 * i
        fn = control_train if c["driver"] == "train_step" else control_inference
        emit(rows, {"kind": "control", "seed": seed, "readings": fn(c, seed, device)})
    for fault in filter(None, args.faults.split(",")):
        for i in range(args.fault_seeds):
            seed = args.first_seed + 7919 * i
            r, _, readings = harness.run_once(args.workload, seed, args.seconds, False,
                                              device=device, fault=fault)
            emit(rows, {"kind": f"fault:{fault}", "seed": seed, "correct": r["correct"],
                        "readings": readings})
    summary = {}
    for kind in sorted({r["kind"] for r in rows}):
        vals = [r["readings"] for r in rows if r["kind"] == kind]
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(v[k] for v in vals) for k in vals[0]}
    print(json.dumps({"summary": summary, "device": torch.cuda.get_device_name(0)}), flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"imported {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())

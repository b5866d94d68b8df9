"""The readings that a cell's limits are set from, in one process on the
card: sound runs of the program on many seeds (short windows), the
control on a few (the program module's ``control``: the reference in the
program's place, one precision below the configuration's), and planted
faults. Prints one JSON line per run and a summary: the largest sound
reading and the smallest control reading of each number.

    python -m portbench.calibrate --workload base_offline_pose --seeds 12 \
        --control-seeds 3 --seconds 2 [--faults wrong_rows,half_batch]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import harness
from portbench.reference import train as ref_train

BASE_SEED = 3_000_000_000


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
        if hasattr(run, "record") and i < 2:
            ref = run.reference()
            gaps = ref_train.leaf_gaps(run.record["grad"], ref["grad"], list(ref["grad"]))
            print(json.dumps({"worst_grad_leaves": sorted(gaps.items(), key=lambda kv: -kv[1])[:4],
                              "program_losses": run.record["losses"],
                              "reference_losses": ref["losses"]}), flush=True)
    for i in range(args.control_seeds):
        seed = args.first_seed + 7919 * i
        emit(rows, {"kind": "control", "seed": seed,
                    "readings": c["program"].control(c, seed, device)})
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

"""The pose kernel and the plain solver judged on the same frames: an
offline cell's whole frame pool through the pipeline, whose corners each
solver then solves, both answers judged by the cell's reference
(``portbench.programs.<program>.judge``, as the benchmark judges a run).

    python scripts/compare_pose_frames_left.py CELL SEED [SEED ...]

on the card, from the repository's root (CELL: ``base_offline_pose`` or
``hires_offline_pose``). The corners are the pipeline's; each
``solve_pose`` call is answered by the kernel (``pnp.solve_pnp``) and, on
the same arguments, by ``pnp.solve_pnp_plain`` (the operations that the
pose graph replayed before the kernel). Prints one JSON line a seed: for
each solver ``pose_frames``, ``pose_frames_left`` and ``pose_gap_max`` over
the whole pool and over the 256 rows that a run closing on the pool's last
batch judges, and the frames whose ``ok`` the two solvers give differently,
with their number of corners.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deepcharuco_tpu_torch.pnp import solve_pnp_plain  # noqa: E402
from portbench import frames, harness  # noqa: E402
from portbench.common import full_float32, sample_rows  # noqa: E402

KEYS = ("keypoints", "valid", "refined", "ok", "rvec", "tvec", "reproj_rms")


def answers(pipe, pool, dev):
    """(kernel's answers, plain solver's answers), numpy, one row a frame."""
    solve = pipe.solve_pose
    plain = []

    def both(refined, valid):
        plain.append(solve_pnp_plain(pipe.object_points, refined, valid, pipe._K, pipe._dist,
                                     iters=pipe.pnp_iters))
        return solve(refined, valid)

    pipe.solve_pose = both
    kern = []
    for b in pool:
        out = pipe.forward_device(torch.from_numpy(b).to(dev), with_pose=True)
        kern.append([t.cpu().numpy() for t in out])
    pipe.solve_pose = solve
    cat = lambda rows: {k: np.concatenate([r[i] for r in rows]) for i, k in enumerate(KEYS)}
    k = cat(kern)
    p = dict(k, **{key: np.concatenate([t[i].cpu().numpy() for t in plain])
                   for i, key in enumerate(KEYS[3:])})
    return k, p


def readings(c, seed, dev, frames_u8, out):
    with full_float32():
        r = c["program"].judge(c["config"], harness.ROOT, seed, dev, frames_u8, out)
    return {k: r[k] for k in ("pose_frames", "pose_frames_left", "pose_gap_max")}


def main() -> int:
    cell, seeds = sys.argv[1], [int(s) for s in sys.argv[2:]]
    dev = torch.device("cuda")
    c = harness.cell(cell)
    cfg, p = c["config"], c["params"]
    pipe = c["program"].build(cfg, harness.ROOT, 0, dev)
    for seed in seeds:
        pool = frames.batch_pool(seed, cfg["input_hw"], p["batch"], p["pool_batches"], p)
        kern, plain = answers(pipe, pool, dev)
        frames_u8 = np.concatenate(pool)
        rows = [b * p["batch"] + r for b, r in
                sample_rows(seed, len(pool), p["batch"], p["check_frames"])]
        line = {"cell": cell, "seed": seed, "frames": len(frames_u8),
                "sample_frames": len(rows)}
        for tag, out in (("kernel", kern), ("plain", plain)):
            line[tag] = readings(c, seed, dev, frames_u8, out)
            line[f"{tag}_sample"] = readings(c, seed, dev, frames_u8[rows],
                                             {k: v[rows] for k, v in out.items()})
        differ = np.flatnonzero(kern["ok"] != plain["ok"])
        line["ok_differs"] = [{"frame": int(i), "corners": int(kern["valid"][i].sum()),
                               "kernel_ok": bool(kern["ok"][i])} for i in differ]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

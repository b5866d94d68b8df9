#!/usr/bin/env python3
"""Where the port's main path spends its time on the card.

Runs the pose path (frames → corners → sub-pixel corners → pose, shipped
weights, bf16, the fixture's camera) on batches of 256 unique 240×320 uint8
frames built from the fixture frames, and prints:

- per-stage device times with CUDA events (upload, gray, detector, decode,
  patch gather, RefineNet, sub-pixel decode, pose tail, download) for the
  heads+decode path and the fused-head path;
- the wall time of ``detect`` and of ``detect_with_pose`` per batch, and
  from a ``torch.profiler`` window over the same calls the device time per
  batch, their ratio (the device's busy share) and, for ``detect``, the
  kernels by total device time;
- the card's name and power limit from ``nvidia-smi``.

Needs a CUDA device: ``python3 scripts/profile_torch_port.py``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from deepcharuco_tpu_torch.configs import default_config  # noqa: E402
from deepcharuco_tpu_torch.ops import (extract_patches, pred_to_keypoints,  # noqa: E402
                                       refine_keypoints)
from deepcharuco_tpu_torch.ops.cuda_fused import fused_head_decode  # noqa: E402
from deepcharuco_tpu_torch.pipeline import (Camera, InferencePipeline,  # noqa: E402
                                            _to_gray_input)
from deepcharuco_tpu_torch.weights import variables_from_npz  # noqa: E402

N = 256
FIXTURE = os.path.join(ROOT, "tests/data/torch_port_frames.npz")


def batches(count: int) -> list:
    frames = np.load(FIXTURE)["frames"]
    rng = np.random.default_rng(1)
    out = []
    for tag in range(count):
        src = frames[rng.integers(0, len(frames), size=N)]
        b = np.stack([np.roll(f, int(s) + tag, axis=1)
                      for f, s in zip(src, rng.integers(0, 32, size=N))])
        noise = rng.integers(-25, 26, size=b.shape, dtype=np.int16)
        out.append(np.clip(b.astype(np.int16) + noise, 0, 255).astype(np.uint8))
    return out


def stage_times(pipe, host_batches, fused: bool) -> dict:
    """Mean device ms per stage over the batches (after one warm-up)."""
    names = ["upload", "gray", "detector", "decode", "patches", "refinenet",
             "subpixel", "pose", "download"]
    sums = dict.fromkeys(names, 0.0)
    for i, hb in enumerate(host_batches):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        with torch.inference_mode():
            ev[0].record()
            x = torch.from_numpy(hb).to("cuda")
            ev[1].record()
            g = _to_gray_input(x)
            ev[2].record()
            if fused:
                trunk = pipe.detector(g, trunk_only=True)["trunk"]
                ev[3].record()
                kp, valid = fused_head_decode(trunk, pipe.folded, 16)
            else:
                out = pipe.detector(g)
                ev[3].record()
                kp, valid = pred_to_keypoints(out["loc"], out["ids"], 16)
            ev[4].record()
            patches = extract_patches(g, kp)
            ev[5].record()
            n, k, p, _ = patches.shape
            heat = pipe.refinenet(patches.reshape(n * k, p, p, 1)).reshape(n, k, 64, 64)
            ev[6].record()
            refined = refine_keypoints(heat, kp)
            ev[7].record()
            pose = pipe.solve_pose(refined, valid)
            ev[8].record()
            _ = [t.cpu() for t in (kp, valid, refined, *pose)]
            ev[9].record()
        torch.cuda.synchronize()
        if i == 0:
            continue
        for j, name in enumerate(names):
            sums[name] += ev[j].elapsed_time(ev[j + 1])
    return {k: v / (len(host_batches) - 1) for k, v in sums.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print("card:", smi.stdout.strip())
    cfg = default_config()
    dv = variables_from_npz(os.path.join(ROOT, "artifacts/detector_devsynth.npz"))
    rv = variables_from_npz(os.path.join(ROOT, "artifacts/refinenet_devsynth.npz"))
    with np.load(FIXTURE) as fix:
        cam = Camera(K=fix["K"], dist=fix["dist"])
    hb = batches(9)
    for fused in (False, True):
        pipe = InferencePipeline(cfg, dv, rv, camera=cam, fused_head=fused)
        st = stage_times(pipe, hb, fused)
        total = sum(st.values())
        line = ", ".join(f"{k} {v:.3f}" for k, v in st.items())
        print(f"stages [{'fused' if fused else 'heads+decode'}] ms per batch of {N}: "
              f"{line}; sum {total:.3f}")

    pipe = InferencePipeline(cfg, dv, rv, camera=cam)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):   # the tracer's one-time start-up cost
        pipe.detect(hb[0])
    for name, fn in (("detect_with_pose", pipe.detect_with_pose), ("detect", pipe.detect)):
        fn(hb[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in hb[1:5]:
            fn(b)
        wall_ms = 1e3 * (time.perf_counter() - t0) / 4
        with profile(activities=acts) as prof:
            for b in hb[1:5]:
                fn(b)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 4
        print(f"{name}: {wall_ms:.3f} ms per batch of {N} on the host clock (no profiler); "
              f"device kernels and copies {dev_ms:.3f} ms per batch under the profiler; "
              f"busy share {100 * dev_ms / wall_ms:.1f}%")
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=25)
    print(table)
    return 0


if __name__ == "__main__":
    sys.exit(main())

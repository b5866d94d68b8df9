#!/usr/bin/env python3
"""How much the fused kernel could gain by gathering the trunk once for both heads.

``csrc/fused_head_decode.cu`` runs the two 3×3 heads one after the other on
the same 16×8-cell tile, so its producer loads every trunk box twice: 36 TMA
boxes per tile, 1.51 GB per batch of 256 frames on a 30×40 grid. This probe
builds a copy of the kernel in which the second head loads no trunk box (its
stages bring only the weight tile, and the consumers read whatever trunk box
the stage held before). Its outputs are wrong, but its traffic is what a
design that shares the trunk between the heads would move, with all else
kept. The kernel and the probe are timed in turns (kernel, probe, probe,
kernel) on the same trunk at N=256 and N=1, by CUDA-graph replay as in
``chip_smoke.py`` phase 6. The difference bounds what sharing the trunk can
save in this design.

Needs a CUDA device and nvcc: ``python3 scripts/probe_fused_trunk_once.py``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from deepcharuco_tpu_torch import _build  # noqa: E402
from deepcharuco_tpu_torch.ops import cuda_fused  # noqa: E402
from deepcharuco_tpu_torch.ops.image import normalize_gray  # noqa: E402
from deepcharuco_tpu_torch.weights import load_detector, variables_from_npz  # noqa: E402

# The producer's two lines that load a stage's trunk box; the probe keeps
# them for the first head only.
PATCHES = [
    ("mbar_expect_tx(full + s, kStageBytes);",
     "mbar_expect_tx(full + s, h == 0 ? kStageBytes : kBBytes);"),
    ("            tma_load_4d(st, &tm_trunk,", "            if (h == 0) tma_load_4d(st, &tm_trunk,"),
]


def build_probe():
    src = (_build.CSRC / "fused_head_decode.cu").read_text()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"fused_head_decode.cu no longer has {old!r} once")
        src = src.replace(old, new)
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "fused_trunk_once.cu").write_text(src)
    so = out / "fused_trunk_once.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(so), str(out / "fused_trunk_once.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.dc_fused_head_decode
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return lib, fn


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_fused_trunk_once: no CUDA device", file=sys.stderr)
        return 1
    print("card:", chip_smoke.smi())
    variants = {"kernel": cuda_fused._fn(), "probe": build_probe()}
    dev = torch.device("cuda")
    frames = np.load(chip_smoke.FIXTURE)["frames"]
    batch = chip_smoke.make_batches(frames, 1, np.random.default_rng(0))[0]
    det = load_detector(chip_smoke.DET, device=dev)
    folded = cuda_fused.head_params(variables_from_npz(chip_smoke.DET), 16, dev)
    with torch.inference_mode():
        trunk = det(normalize_gray(torch.from_numpy(batch).to(dev)), trunk_only=True)["trunk"]
    real_fn = cuda_fused._fn
    try:
        for n in (chip_smoke.N, 1):
            tr = trunk[:n].contiguous()
            times = []
            for name in ("kernel", "probe", "probe", "kernel"):
                cuda_fused._fn = lambda v=variants[name]: v
                times.append((name, chip_smoke.graph_ms(
                    lambda: cuda_fused.fused_head_decode(tr, folded, 16))))
            print(f"N={n}: " + ", ".join(f"{name} {ms:.4f} ms" for name, ms in times))
    finally:
        cuda_fused._fn = real_fn
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the int8 detector's im2col on the card, copied as bytes and as words.

``models.quant._im2col`` concatenates the nine shifted views of the padded
int8 activations. This probe times it at the shape of the detector's
largest layer (``conv1b``: 27 frames of 240×320 with 64 channels, one chunk
of ``QuantDetector``) with the views concatenated as int8 and as int32 words
of four channels, in turns, checks that both give the same matrix, and
prints the card's name and power limit beside the times.

Run from the repository root on a machine with a CUDA device:
``python3 scripts/probe_torch_port_im2col.py``.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deepcharuco_tpu_torch.models.quant import _im2col  # noqa: E402


def cuda_ms(fn, iters: int = 10) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_port_im2col: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    q = torch.randint(-128, 128, (27, 242, 322, 64), dtype=torch.int8, device="cuda")
    same = torch.equal(_im2col(q, 3, words=False), _im2col(q, 3, words=True))
    gb = 2 * 27 * 240 * 320 * 576 / 1e9
    times = {tag: [] for tag in ("bytes", "words")}
    for _ in range(2):
        for tag in times:
            times[tag].append(cuda_ms(lambda: _im2col(q, 3, words=(tag == "words"))))
    print(f"{card.strip()}: im2col of (27, 242, 322, 64) int8, {gb:.2f} GB read and "
          f"written: as bytes {times['bytes'][0]:.3f} / {times['bytes'][1]:.3f} ms, as "
          f"words {times['words'][0]:.3f} / {times['words'][1]:.3f} ms; equal: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

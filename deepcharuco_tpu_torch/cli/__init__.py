"""Command-line entry points of the port (``python -m
deepcharuco_tpu_torch.cli.<name>``): ``train``, ``train_refinenet``,
``benchmark``, ``infer``, ``eval``, ``pose_video``. Each runs on the card
unless ``--device cpu`` is given. Frames come from image files through cv2
or from a ``.npy``/``.npz`` file of uint8 frames, which needs no cv2."""

from __future__ import annotations

import glob
import os
from typing import List, Tuple

import numpy as np


def not_ported(what: str, item: str):
    """Raise for a flag whose machinery the port does not have yet;
    ``item`` is its entry in ROADMAP.md §A."""
    raise NotImplementedError(f"{what} is not ported to deepcharuco_tpu_torch yet "
                              f"(ROADMAP.md §A, {item})")


def need_cv2(what: str):
    """cv2, or ``SystemExit`` naming what needs it."""
    try:
        import cv2
    except ImportError:
        raise SystemExit(f"{what} needs OpenCV (cv2), which is not installed here; "
                         "pass frames as a .npy/.npz file of uint8 arrays instead, "
                         "or leave the option out") from None
    return cv2


def is_array_file(path: str) -> bool:
    return str(path).endswith((".npy", ".npz"))


def load_frame_array(path: str) -> np.ndarray:
    """uint8 frames (N, H, W) gray or (N, H, W, 3) BGR from a ``.npy`` file
    or the first array of a ``.npz`` (``frames`` if it has one)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            arr = z["frames"] if "frames" in z.files else z[z.files[0]]
    else:
        arr = np.load(path)
    if arr.dtype != np.uint8 or arr.ndim not in (3, 4):
        raise SystemExit(f"{path}: expected uint8 frames (N, H, W[, 3]), got "
                         f"{arr.dtype} {arr.shape}")
    return arr


def read_frames(patterns: List[str]) -> List[Tuple[str, np.ndarray]]:
    """(name, uint8 frame) pairs from image paths/globs (cv2) and frame
    array files (numpy); unreadable images are reported and skipped."""
    out = []
    for pattern in patterns:
        for path in sorted(glob.glob(pattern)) or [pattern]:
            if is_array_file(path):
                frames = load_frame_array(path)
                out += [(f"{path}[{i}]", f) for i, f in enumerate(frames)]
                continue
            img = need_cv2(f"reading the image {os.path.basename(path)}").imread(path)
            if img is None:
                print(f"skipping unreadable {path}")
                continue
            out.append((path, img))
    return out

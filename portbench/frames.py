"""Inputs made from ``--seed`` on the host: camera frames and labelled
training batches. The same seed gives the same arrays; the program and the
reference are handed the same ones.

Frames follow the port's ``bench`` protocol: the board's frozen render
(``data/board_renders.npz``, a copy of the port's asset at 240 and 480 px)
pasted centred on gray ``background``, each frame rolled left to right by its
own shift below ``roll_max`` (scaled with the resolution), under its own
uniform integer noise of ±``noise`` levels.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

RENDERS = Path(__file__).resolve().parent / "data" / "board_renders.npz"


def board_render(size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(gray uint8 (size, size), inner corners (n_ids, 2) int32 (x, y))."""
    with np.load(RENDERS) as z:
        return z[f"{size}/image"], z[f"{size}/corners"]


def base_frame(hw, background: int) -> np.ndarray:
    """The board render of the frame's height pasted centred on gray."""
    h, w = hw
    board, _ = board_render(min(h, w))
    frame = np.full((h, w), background, np.uint8)
    x0 = (w - board.shape[1]) // 2
    frame[:board.shape[0], x0:x0 + board.shape[1]] = board
    return frame


def noisy_frames(rng: np.random.Generator, base: np.ndarray, n: int, roll_max: int,
                 noise: int) -> np.ndarray:
    """(n, H, W) uint8: ``base`` rolled by a per-frame shift in [0, roll_max)
    along the width, plus per-pixel noise in [-noise, noise]."""
    shifts = rng.integers(0, roll_max, size=n)
    out = np.empty((n, *base.shape), np.uint8)
    for i, s in enumerate(shifts):
        out[i] = np.roll(base, int(s), axis=1)
    levels = rng.integers(0, 2 * noise + 1, size=out.shape, dtype=np.uint8)
    x = out.astype(np.int16)
    x += levels
    x -= noise
    np.clip(x, 0, 255, out=x)
    return x.astype(np.uint8)


def frame_pool(seed: int, hw, count: int, params: dict) -> np.ndarray:
    """``count`` distinct frames of the mix's protocol at resolution ``hw``."""
    rng = np.random.default_rng(seed)
    scale = hw[0] // 240
    return noisy_frames(rng, base_frame(hw, params["background"]), count,
                        params["roll_max"] * scale, params["noise"])


def batch_pool(seed: int, hw, batch: int, batches: int, params: dict) -> List[np.ndarray]:
    """``batches`` batches of ``batch`` distinct frames each."""
    pool = frame_pool(seed, hw, batch * batches, params)
    return [pool[i * batch:(i + 1) * batch] for i in range(batches)]


def training_batches(seed: int, hw, n_ids: int, batch: int, batches: int, params: dict):
    """Labelled detector batches: every sample the 240-px board pasted at its
    own horizontal offset on its own gray level, under its own noise, with
    the class maps of the corners placed (loc: the corner's pixel in its
    8x8 cell, 64 elsewhere; ids: the corner id, ``n_ids`` elsewhere).
    Returns [(images (B, H, W, 1) float32 normalized as (g - 128)/255,
    loc (B, H/8, W/8) int32, ids (B, H/8, W/8) int32)] * batches."""
    rng = np.random.default_rng(seed)
    h, w = hw
    board, corners = board_render(h)
    n = batch * batches
    x0 = rng.integers(0, w - board.shape[1] + 1, size=n)
    lo, hi = params["background"]
    bg = rng.integers(lo, hi + 1, size=n)
    img = np.empty((n, h, w), np.int16)
    for i in range(n):
        img[i] = bg[i]
        img[i, :, x0[i]:x0[i] + board.shape[1]] = board
    img += rng.integers(-params["noise"], params["noise"] + 1, size=img.shape,
                        dtype=np.int16)
    np.clip(img, 0, 255, out=img)
    images = ((img.astype(np.float32) - 128.0) / 255.0)[..., None]
    hc, wc = h // 8, w // 8
    loc = np.full((n, hc, wc), 64, np.int32)
    ids = np.full((n, hc, wc), n_ids, np.int32)
    for i in range(n):
        for k, (x, y) in enumerate(corners):
            x = int(x) + int(x0[i])
            loc[i, y // 8, x // 8] = (y % 8) * 8 + x % 8
            ids[i, y // 8, x // 8] = k
    return [(images[j * batch:(j + 1) * batch], loc[j * batch:(j + 1) * batch],
             ids[j * batch:(j + 1) * batch]) for j in range(batches)]

"""Offline pairs: batches of image pairs from the host through
``serving.pipelined_map`` with ``depth`` batches in flight, as the
``offline`` driver serves single frames. Rows 2i and 2i+1 of a batch are
pair i: a frame of the ``offline`` protocol (``frames.py``: the board
pasted on gray ``background``, rolled by its own shift below ``roll_max``,
under its own noise of ±``noise`` levels) and the same rolled frame warped
by a random homography that moves each image corner by up to ``warp`` of
the side, under fresh noise. ``batch`` counts frames (twice the pairs); a
pool of ``pool_batches`` batches is made from the seed on the host and
cycled. The window is the ``offline`` driver's: from the first batch's
submission to the last result on the host.

``fps``: frames whose keypoints and matches reached the host, over the
window. The comparison draws ``check_pairs`` whole pairs among those
handed out. ``model`` is the CPU tests' small model (``SMALL``): it
replaces keys of the configuration on the CPU only, and a run on the card
refuses a ``model`` that is not empty, so that a mix cannot cut the
configuration's widths. Every cell's mix leaves it empty.
"""

from __future__ import annotations

import numpy as np

from portbench import frames
from portbench.common import full_float32, sample_rows
from portbench.drivers import offline
from portbench.harness import ROOT

TASK = "serve"
SMALL = dict(batch=8, pool_batches=2, warm_batches=1, check_pairs=4, trace_skip=1,
             trace_steps=1, trace_drop=0,
             model=dict(input_hw=[96, 128], descriptor_dim=64, num_heads=2, n_layers=2,
                        max_num_keypoints=128))


def config(c: dict, device) -> dict:
    """The cell's configuration, with ``model``'s keys over it on the CPU."""
    import torch

    model = c["params"].get("model") or {}
    if model and torch.device(device).type != "cpu":
        raise ValueError(f"offline_pairs: `model` resizes the configuration in the CPU tests "
                         f"only; a run on {device} takes the configuration as it is, got "
                         f"{model}")
    return {**c["config"], **model}


def homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 3x3 homography taking four points ``src`` (4, 2) to ``dst``."""
    a = []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
    h = np.linalg.solve(np.array(a, np.float64), dst.reshape(-1).astype(np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def warp(img: np.ndarray, hom: np.ndarray, fill: float) -> np.ndarray:
    """``img`` (H, W) float32 seen through ``hom`` (source → output pixel
    centres), bilinear, ``fill`` outside."""
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    inv = np.linalg.inv(hom).astype(np.float32)
    d = inv[2, 0] * xs + inv[2, 1] * ys + inv[2, 2]
    # beyond one pixel outside, every sample is ``fill``: clip there
    x = np.clip((inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]) / d, -1, w)
    y = np.clip((inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]) / d, -1, h)
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = x - x0, y - y0
    pad = np.pad(img, ((1, 2), (1, 2)), constant_values=fill).ravel()
    i = ((y0.astype(np.int64) + 1) * (w + 3) + x0.astype(np.int64) + 1).ravel()
    fx, fy = fx.ravel(), fy.ravel()
    top = pad[i] * (1 - fx) + pad[i + 1] * fx
    bottom = pad[i + w + 3] * (1 - fx) + pad[i + w + 4] * fx
    return (top * (1 - fy) + bottom * fy).reshape(h, w)


def noisy(rng: np.random.Generator, img: np.ndarray, noise: int) -> np.ndarray:
    levels = rng.integers(-noise, noise + 1, size=img.shape, dtype=np.int16)
    return np.clip(np.rint(img).astype(np.int16) + levels, 0, 255).astype(np.uint8)


def base_frame(hw, background: int) -> np.ndarray:
    """``frames.base_frame`` at any size: the board's 480 or 240 px render,
    taken to the frame's height by nearest neighbour (as it is at 240 and
    480), pasted centred on gray."""
    h, w = hw
    s = min(h, w)
    board, _ = frames.board_render(480 if s >= 480 else 240)
    idx = np.arange(s) * board.shape[0] // s
    frame = np.full((h, w), background, np.uint8)
    x0 = (w - s) // 2
    frame[:s, x0:x0 + s] = board[idx][:, idx]
    return frame


def pair_pool(seed: int, hw, batch: int, batches: int, params: dict):
    """``batches`` batches of ``batch`` frames (``batch // 2`` pairs each)."""
    rng = np.random.default_rng([seed, 17])
    h, w = hw
    base = base_frame(hw, params["background"]).astype(np.float32)
    corners = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], np.float64)
    roll_max = params["roll_max"] * max(1, h // 240)
    out = np.empty((batches * batch, h, w), np.uint8)
    for i in range(0, len(out), 2):
        clean = np.roll(base, int(rng.integers(0, roll_max)), axis=1)
        moved = corners + rng.uniform(-1, 1, (4, 2)) * params["warp"] * np.array([w, h])
        out[i] = noisy(rng, clean, params["noise"])
        out[i + 1] = noisy(rng, warp(clean, homography(corners, moved), params["background"]),
                           params["noise"])
    return [out[i * batch:(i + 1) * batch] for i in range(batches)]


def control_inputs(c: dict, seed: int, device) -> dict:
    """The pairs a run of ``seed`` judges (from its first batches) and the
    configuration it runs."""
    cfg, p = config(c, device), c["params"]
    pool = pair_pool(seed, cfg["input_hw"], p["batch"], p["pool_batches"], p)
    per = p["batch"] // 2
    n_batches = max(1, -(-p["check_pairs"] // per))
    picks = sample_rows(seed, n_batches, per, p["check_pairs"])
    return {"frames": np.stack([pool[b % len(pool)][2 * r + j] for b, r in picks
                                for j in (0, 1)]),
            "cfg": cfg}


class Run(offline.Run):
    """The ``offline`` driver's run (its window), on pairs."""

    def __init__(self, cell, seed, seconds, trace, device, fault):
        super().__init__(cell, seed, seconds, trace, device, fault)
        self.cfg = config(cell, device)

    def setup(self):
        from deepcharuco_tpu_torch.serving import pipelined_map

        self.pipelined_map = pipelined_map
        self.pipe = self.prog.build(self.cfg, ROOT, self.seed, self.device)
        self.prog.plant(self)
        p = self.p
        self.pool = pair_pool(self.seed, self.cfg["input_hw"], p["batch"], p["pool_batches"], p)
        for _ in self.pipelined_map(self._fn, self.pool[:p["warm_batches"]], p["depth"],
                                    self.device):
            pass
        self.sync()
        if self.trace:
            self.prog.instrument(self.spans, self.pipe, layers=True)

    def _fn(self, x):
        return self.pipe.forward_device(x)

    def judge(self):
        p = self.p
        picks = sample_rows(self.seed, len(self.results), p["batch"] // 2, p["check_pairs"])
        rows = [(b, 2 * r + j) for b, r in picks for j in (0, 1)]
        frames_u8 = np.stack([self.pool[self.sent[b]][r] for b, r in rows])
        out = {k: np.stack([self.results[b][i][r] for b, r in rows])
               for i, k in enumerate(self.prog.OUTPUTS)}
        with full_float32():
            return self.prog.judge(self.cfg, ROOT, self.seed, self.device, frames_u8, out)

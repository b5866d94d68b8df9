"""SuperPoint's keypoints and descriptors from its two heads, batched on the
device with static shapes (``lightglue/superpoint.py``'s ``simple_nms``,
``top_k_keypoints`` and ``sample_descriptors``, restated for a batch).

- :func:`score_map` — the 65-class logits → full-resolution scores: softmax
  over the classes, the dustbin dropped, each cell's 64 scores placed in
  its 8×8 pixels;
- :func:`simple_nms` — radius-``r`` non-maximum suppression by max-pool
  equality and two rounds of suppression;
- :func:`select` — borders removed, then the ``k`` highest scores of each
  frame and a validity mask: the published code keeps the scores above the
  threshold and then the top ``k`` of those, so a frame where fewer than
  ``k`` pass has ``valid`` False on the rest (keypoint (0, 0), score 0);
- :func:`sample_descriptors` — the dense descriptors L2-normalised, sampled
  bilinearly at the keypoints with the published mapping (cell size 8,
  ``align_corners=True``) and normalised again.

Everything runs in float32, whatever the network's precision. Keypoints are
(x, y) in pixels. Nothing synchronises with the host: no tensor is made
from host values.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def score_map(logits: torch.Tensor) -> torch.Tensor:
    """(N, 65, h, w) logits → (N, 8h, 8w) float32 scores."""
    s = torch.softmax(logits.float(), 1)[:, :-1]
    n, _, h, w = s.shape
    return s.reshape(n, 8, 8, h, w).permute(0, 3, 1, 4, 2).reshape(n, h * 8, w * 8)


def simple_nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """(N, H, W) scores with every point that is not the largest within
    ``radius`` (a (2r+1)² window) set to 0, as ``simple_nms`` does."""
    def max_pool(x):
        return F.max_pool2d(x[:, None], 2 * radius + 1, 1, radius)[:, 0]

    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool(scores)
    for _ in range(2):
        supp_mask = max_pool(max_mask.float()) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool(supp_scores)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def select(scores: torch.Tensor, k: int, threshold: float, border: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, H, W) suppressed scores → (keypoints (N, k, 2) float32 (x, y),
    their scores (N, k), valid (N, k) bool): the scores within ``border``
    pixels of an edge are set to -1, then the ``k`` largest of each frame
    are taken, best first; those not above ``threshold`` are not valid."""
    n, h, w = scores.shape
    if border:
        scores = scores.clone()
        scores[:, :border] = -1
        scores[:, :, :border] = -1
        scores[:, -border:] = -1
        scores[:, :, -border:] = -1
    top, idx = torch.topk(scores.reshape(n, h * w), k, dim=1)
    valid = top > threshold
    xy = torch.stack([idx % w, idx // w], -1).float()
    return (torch.where(valid[..., None], xy, 0.0), torch.where(valid, top, 0.0), valid)


def sample_descriptors(keypoints: torch.Tensor, desc: torch.Tensor, s: int = 8
                       ) -> torch.Tensor:
    """Keypoints (N, k, 2) in pixels and dense descriptors (N, D, h, w) →
    (N, k, D) float32 unit descriptors: the dense map L2-normalised over D,
    sampled bilinearly at ``(kp - s/2 + 0.5) / (wh·s - s/2 - 0.5)`` mapped to
    [-1, 1] (``align_corners=True``), and normalised again."""
    desc = F.normalize(desc.float(), p=2, dim=1)
    n, d, h, w = desc.shape
    # per coordinate with Python scalars: a tensor made from host values
    # would wait for the device
    grid = torch.stack([(keypoints[..., 0] - s / 2 + 0.5) / (w * s - s / 2 - 0.5),
                        (keypoints[..., 1] - s / 2 + 0.5) / (h * s - s / 2 - 0.5)], -1) * 2 - 1
    out = F.grid_sample(desc, grid[:, None], mode="bilinear", align_corners=True)
    return F.normalize(out[:, :, 0], p=2, dim=1).transpose(1, 2)

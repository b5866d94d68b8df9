"""Fixed-capacity patch gather: one patch per corner-id slot, batched over
frames (``deepcharuco_tpu.ops.patches``). Zero padding, then clipping of
the centers into the frame, then a row gather and a column gather."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def extract_patches(gray: torch.Tensor, keypoints: torch.Tensor,
                    patch_size: int = 24) -> torch.Tensor:
    """gray (N, H, W) or (N, H, W, 1) float; keypoints (N, K, 2) (x, y),
    truncated to integers → (N, K, P, P), zero outside the frame."""
    if gray.ndim == 4:
        gray = gray[..., 0]
    n, h, w = gray.shape
    pad = patch_size // 2
    padded = F.pad(gray, (pad, pad, pad, pad))

    kx = keypoints[..., 0].to(torch.int32).clamp(0, w - 1).long()  # (N, K)
    ky = keypoints[..., 1].to(torch.int32).clamp(0, h - 1).long()
    offs = torch.arange(patch_size, device=gray.device)
    rows = ky[..., None] + offs                      # (N, K, P)
    cols = kx[..., None] + offs
    b = torch.arange(n, device=gray.device)[:, None, None]
    p_rows = padded[b, rows]                         # (N, K, P, W+2p)
    idx = cols[:, :, None, :].expand(-1, -1, patch_size, -1)
    return torch.gather(p_rows, 3, idx)              # (N, K, P, P)

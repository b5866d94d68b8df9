"""Fixed-capacity patch gather: one patch per corner-id slot, batched over
frames (``deepcharuco_tpu.ops.patches``). The centers are clipped into the
frame and each patch reads zero outside it, as the JAX package's gather
from a zero-padded frame does.

The gather indexes the frames directly into (N, K, P, P): it makes no padded
copy of the frames and no (N, K, P, W) intermediate of whole rows, both of
which grow with the frame where the result does not (the hi-res tap gathers
from frames 2× or 4× the detector's)."""

from __future__ import annotations

import torch


def extract_patches(gray: torch.Tensor, keypoints: torch.Tensor,
                    patch_size: int = 24) -> torch.Tensor:
    """gray (N, H, W) or (N, H, W, 1) float; keypoints (N, K, 2) (x, y),
    truncated to integers → (N, K, P, P), zero outside the frame."""
    if gray.ndim == 4:
        gray = gray[..., 0]
    n, h, w = gray.shape
    pad = patch_size // 2
    kx = keypoints[..., 0].to(torch.int32).clamp(0, w - 1).long()  # (N, K)
    ky = keypoints[..., 1].to(torch.int32).clamp(0, h - 1).long()
    offs = torch.arange(patch_size, device=gray.device) - pad
    rows = (ky[..., None] + offs)[:, :, :, None]                   # (N, K, P, 1)
    cols = (kx[..., None] + offs)[:, :, None, :]                   # (N, K, 1, P)
    inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    b = torch.arange(n, device=gray.device)[:, None, None, None]
    patches = gray[b, rows.clamp(0, h - 1), cols.clamp(0, w - 1)]  # (N, K, P, P)
    return torch.where(inside, patches, torch.zeros((), dtype=gray.dtype,
                                                    device=gray.device))

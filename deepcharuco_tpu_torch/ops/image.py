"""Image preprocessing on the device: the uint8 frame is shipped once and
converted there (the same arithmetic as ``deepcharuco_tpu.ops.image``)."""

from __future__ import annotations

import torch


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """BGR (..., 3) uint8/float → grayscale (...,) float32, BT.601 weights
    (0.114·B + 0.587·G + 0.299·R) without uint8 rounding."""
    img = img.float()
    return img[..., 0] * 0.114 + img[..., 1] * 0.587 + img[..., 2] * 0.299


def normalize_gray(gray: torch.Tensor) -> torch.Tensor:
    """(g − 128)/255: (..., H, W) uint8/float → float32 (..., H, W, 1)."""
    return ((gray.float() - 128.0) / 255.0)[..., None]


def preprocess_bgr(img: torch.Tensor) -> torch.Tensor:
    """BGR uint8 (..., H, W, 3) → normalized gray (..., H, W, 1) float32."""
    return normalize_gray(bgr_to_gray(img))


def downsample2x(gray: torch.Tensor) -> torch.Tensor:
    """2×2 average pool (..., 2H, 2W, C) → (..., H, W, C); even sizes only."""
    *lead, h, w, c = gray.shape
    if h % 2 or w % 2:
        raise ValueError(f"downsample2x needs even spatial dims, got {h}x{w}")
    x = gray.reshape(*lead, h // 2, 2, w // 2, 2, c)
    return x.mean(dim=(-2, -4))

"""Gaussian heatmap labels (``deepcharuco_tpu.ops.heatmap``).

The reference splats its RefineNet targets with a numba loop
(``src/data_refinenet.py:16-38``): ``exp(−d²/2σ²)`` per pixel, skipped where
the exponent exceeds ln 100, clamped to 1. For integer corner positions the
closed form below gives the same values, in numpy on the host or in torch.
"""

from __future__ import annotations

import numpy as np

_LN100 = 4.6052


def gaussian_heatmap(cx, cy, size: int = 64, sigma: float = 2.0, xp=np):
    """(size, size) float32 heatmap with a thresholded Gaussian at integer
    (cx, cy). ``xp``: ``numpy`` or ``torch``."""
    ys = xp.arange(size, dtype=xp.float32)[:, None]
    xs = xp.arange(size, dtype=xp.float32)[None, :]
    d2 = (xs - cx) ** 2 + (ys - cy) ** 2
    expo = d2 / (2.0 * sigma * sigma)
    return xp.where(expo > _LN100, xp.zeros_like(expo), xp.exp(-expo)).clip(max=1.0)

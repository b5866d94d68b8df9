"""RefineNet — per-corner sub-pixel refinement network.

Same network as ``deepcharuco_tpu.models.RefineNet`` with its defaults: a
24×24 gray patch centered on a detected corner goes through four VALID
3×3 convs (24→16), a 2×2 max-pool (→8), SAME conv pairs around three
nearest-neighbour ×2 upsamples (8→64), and a conv-BN-ReLU + 1×1 head to a
64×64 heatmap of the central 8×8 px at 8× resolution. Channels
64/128/128/128/64.

The JAX package's other variants (``patch_size=32``, ``upsample=
"bilinear"``, ``offset_head``) are not ported yet (ROADMAP.md, A2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deepcharuco_tpu_torch.models.detector import (ConvBNRelu, pool, to_nchw,
                                                   to_nhwc)


class RefineNet(nn.Module):
    """(N, 24, 24, 1) patch → (N, 64, 64, 1) float32 heatmap."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 upsample: str = "nearest", patch_size: int = 24,
                 offset_head: bool = False):
        super().__init__()
        if patch_size != 24 or upsample != "nearest" or offset_head:
            raise NotImplementedError(
                "the port's RefineNet has patch_size=24 and nearest upsampling "
                "only; 32-px patches, bilinear upsampling and the offset head "
                "are open items (ROADMAP.md, A2)")
        self.dtype = dtype
        self.patch_size = patch_size
        c1, c2, c3, c4, c5 = 64, 128, 128, 128, 64
        valid = lambda cin, cout: ConvBNRelu(cin, cout, 0, dtype)
        same = lambda cin, cout: ConvBNRelu(cin, cout, 1, dtype)
        self.conv1a, self.conv1b = valid(1, c1), valid(c1, c1)
        self.conv2a, self.conv2b = valid(c1, c2), valid(c2, c2)
        self.conv3a, self.conv3b = same(c2, c3), same(c3, c3)
        self.conv4a, self.conv4b = same(c3, c4), same(c4, c4)
        self.conv5a, self.conv5b = same(c4, c5), same(c5, c5)
        self.convPa = same(c5, 64)
        self.convPb = nn.Conv2d(64, 1, 1, dtype=dtype)

    def forward(self, x):
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        x = to_nchw(x.to(self.dtype))
        x = self.conv2b(self.conv2a(self.conv1b(self.conv1a(x))))
        x = pool(x)
        x = up(self.conv3b(self.conv3a(x)))
        x = up(self.conv4b(self.conv4a(x)))
        x = up(self.conv5b(self.conv5a(x)))
        heat = self.convPb(self.convPa(x))
        return to_nhwc(heat.float())

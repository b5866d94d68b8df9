"""RefineNet — per-corner sub-pixel refinement network.

Same network as ``deepcharuco_tpu.models.RefineNet``, every variant: a
``patch_size``×``patch_size`` gray patch centered on a detected corner goes
through four VALID 3×3 convs (24→16, or 32→24), a 2×2 max-pool (→8, or →12
and two more VALID convs ``conv2c``/``conv2d`` →8), SAME conv pairs around
three ×2 upsamples (8→64, nearest or bilinear), and a conv-BN-ReLU + 1×1 head
to a 64×64 heatmap of the central 8×8 px at 8× resolution. Channels
64/128/128/128/64. Every layer of the 24-px net keeps its name in the 32-px
net, and the upsampling carries no parameters, so either mode loads the same
weights.

``offset_head=True`` adds the offset-regression branch on the 8×8
bottleneck (``convOa`` → pool → ``denseOa`` → ReLU → ``denseOb``): the
corner's (dx, dy) in image px from the patch center. The forward pass then
returns ``{"heat", "offset"}``. ``train=True`` runs every BatchNorm on batch
statistics and updates the running ones (``models.detector.ConvBNRelu``);
with ``mesh`` those statistics reduce over its ``data`` axis (patches are
never split spatially).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deepcharuco_tpu_torch.models.detector import ConvBNRelu, as_f32, to_nchw, to_nhwc, up


class RefineNet(nn.Module):
    """(N, P, P, 1) patch → (N, 64, 64, 1) float32 heatmap, P ∈ {24, 32}."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 upsample: str = "nearest", patch_size: int = 24,
                 offset_head: bool = False):
        super().__init__()
        if patch_size not in (24, 32):
            raise ValueError(f"patch_size must be 24 or 32, got {patch_size}")
        self.dtype = dtype
        self.upsample = upsample
        self.patch_size = patch_size
        self.offset_head = offset_head
        c1, c2, c3, c4, c5 = 64, 128, 128, 128, 64
        valid = lambda cin, cout: ConvBNRelu(cin, cout, 0, dtype)
        same = lambda cin, cout: ConvBNRelu(cin, cout, 1, dtype)
        self.conv1a, self.conv1b = valid(1, c1), valid(c1, c1)
        self.conv2a, self.conv2b = valid(c1, c2), valid(c2, c2)
        if patch_size == 32:
            self.conv2c, self.conv2d = valid(c2, c2), valid(c2, c2)
        self.conv3a, self.conv3b = same(c2, c3), same(c3, c3)
        self.conv4a, self.conv4b = same(c3, c4), same(c4, c4)
        self.conv5a, self.conv5b = same(c4, c5), same(c5, c5)
        self.convPa = same(c5, 64)
        self.convPb = nn.Conv2d(64, 1, 1, dtype=dtype)
        if offset_head:
            self.convOa = same(c3, 128)
            self.denseOa = nn.Linear(4 * 4 * 128, 256, dtype=dtype)
            self.denseOb = nn.Linear(256, 2, dtype=dtype)

    def _up(self, x):
        # any mode but "bilinear" is nearest, as in the JAX module;
        # half-pixel centers with clamped edges are jax.image.resize's ×2
        if self.upsample == "bilinear":
            return F.interpolate(x, scale_factor=2, mode="bilinear",
                                 align_corners=False)
        return up(x)

    def forward(self, x, train: bool = False, mesh=None):
        stats = None if mesh is None else mesh.data
        blk = lambda m, x, then=None: m(x, train, stats, then=then)
        if self.upsample == "bilinear":
            blk_up = lambda m, x: self._up(blk(m, x))
        else:                                        # the block runs the upsample
            blk_up = lambda m, x: blk(m, x, "up")
        x = to_nchw(x.to(self.dtype))
        x = blk(self.conv2a, blk(self.conv1b, blk(self.conv1a, x)))
        x = blk(self.conv2b, x, "pool")              # 16 → 8, or 24 → 12
        if self.patch_size == 32:
            x = blk(self.conv2d, blk(self.conv2c, x))        # 12 → 10 → 8
        x = blk(self.conv3a, x)
        if self.offset_head:                         # the bottleneck feeds both heads
            bottleneck = blk(self.conv3b, x)         # (N, c3, 8, 8)
            x = self._up(bottleneck)
        else:
            x = blk_up(self.conv3b, x)
        x = blk_up(self.conv4b, blk(self.conv4a, x))
        x = blk_up(self.conv5b, blk(self.conv5a, x))
        heat = to_nhwc(as_f32(self.convPb(blk(self.convPa, x))))
        if not self.offset_head:
            return heat
        o = blk(self.convOa, bottleneck, "pool")     # (N, 128, 4, 4)
        # denseOa's 2048 inputs are ordered (row, col, channel), as the
        # JAX module flattens its NHWC map
        o = to_nhwc(o).flatten(1)
        offset = self.denseOb(F.relu(self.denseOa(o)))
        return {"heat": heat, "offset": as_f32(offset)}

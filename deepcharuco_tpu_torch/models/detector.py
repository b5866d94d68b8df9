"""Deep ChArUco detector — SuperPoint-style fully-convolutional network.

Same network as ``deepcharuco_tpu.models.Detector``: a VGG-style trunk of
conv pairs at 64/64/128/128 channels with three 2×2 max-pools (floor), a
``loc`` head (3×3 conv to 256 → 1×1 conv to 65 = 8·8 sub-cell positions +
dustbin) and an ``ids`` head (3×3 conv to 256 → 1×1 conv to n_ids+1).
BatchNorm (eps 1e-5) runs before ReLU; the heads carry no activation.
``train=True`` (the trainers') normalizes with batch statistics and updates
the running ones (:class:`ConvBNRelu`).

Public layout is NHWC, as in the JAX package. Inside, convolutions run on
``channels_last`` NCHW tensors, so a ``permute(0, 2, 3, 1)`` of any
activation is a free, contiguous NHWC view — the view the decode kernels
read. Convolutions run in ``dtype`` (bf16 by default) with float32
parameters for BatchNorm; the logits come back as float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC → channels_last NCHW (free when ``x`` is contiguous NHWC)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """channels_last NCHW → contiguous NHWC (free for channels_last input)."""
    return x.permute(0, 2, 3, 1).contiguous()


class ConvBNRelu(nn.Module):
    """3×3 conv → BatchNorm → ReLU.

    ``padding=1`` is SAME, ``padding=0`` VALID. The conv runs in ``dtype``;
    BatchNorm keeps float32 parameters and normalizes in float32 before the
    result is rounded back to ``dtype``, as Flax does for a bf16 module.

    ``train=False`` normalizes with the running statistics. ``train=True``
    normalizes with the batch's mean and *biased* variance, computed as
    Flax does (``E[x²] − E[x]²`` in float32, clipped at 0), and updates the
    running statistics as Flax's ``BatchNorm(momentum=0.9)`` does:
    ``running = 0.9·running + 0.1·batch`` with the biased variance. Torch's
    own update (``F.batch_norm(training=True)``) would store the unbiased
    variance, n/(n−1) larger, so the update is written out here.
    """

    MOMENTUM = 0.9

    def __init__(self, cin: int, cout: int, padding: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=padding, dtype=dtype)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)

    def forward(self, x, train: bool = False):
        x = self.conv(x)
        bn = self.bn
        if not train:
            x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                             False, 0.0, bn.eps)
            return F.relu(x)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            bn.running_mean.mul_(m).add_((1 - m) * mean)
            bn.running_var.mul_(m).add_((1 - m) * var)
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
        return F.relu(y.to(x.dtype))


def pool(x):
    return F.max_pool2d(x, 2, 2)


class Detector(nn.Module):
    """(N, H, W, 1) normalized gray → ``{"loc": (N, H/8, W/8, 65),
    "ids": (N, H/8, W/8, n_ids+1)}`` float32 NHWC, or ``{"trunk":
    (N, H/8, W/8, 128)}`` in ``dtype`` under ``trunk_only=True``."""

    def __init__(self, n_ids: int = 16, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.n_ids = n_ids
        self.dtype = dtype
        c1, c2, c3, c4, c5 = 64, 64, 128, 128, 256
        blk = lambda cin, cout: ConvBNRelu(cin, cout, 1, dtype)
        self.conv1a, self.conv1b = blk(1, c1), blk(c1, c1)
        self.conv2a, self.conv2b = blk(c1, c2), blk(c2, c2)
        self.conv3a, self.conv3b = blk(c2, c3), blk(c3, c3)
        self.conv4a, self.conv4b = blk(c3, c4), blk(c4, c4)
        self.convPa = blk(c4, c5)
        self.convPb = nn.Conv2d(c5, 65, 1, dtype=dtype)
        self.convDa = blk(c4, c5)
        self.convDb = nn.Conv2d(c5, n_ids + 1, 1, dtype=dtype)

    def forward(self, x, train: bool = False, trunk_only: bool = False):
        x = to_nchw(x.to(self.dtype))
        x = pool(self.conv1b(self.conv1a(x, train), train))
        x = pool(self.conv2b(self.conv2a(x, train), train))
        x = pool(self.conv3b(self.conv3a(x, train), train))
        x = self.conv4b(self.conv4a(x, train), train)
        if trunk_only:
            return {"trunk": to_nhwc(x)}
        loc = self.convPb(self.convPa(x, train))
        ids = self.convDb(self.convDa(x, train))
        return {"loc": to_nhwc(loc.float()), "ids": to_nhwc(ids.float())}

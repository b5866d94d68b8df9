"""Deep ChArUco detector — SuperPoint-style fully-convolutional network.

Same network as ``deepcharuco_tpu.models.Detector``: a VGG-style trunk of
conv pairs at 64/64/128/128 channels with three 2×2 max-pools (floor), a
``loc`` head (3×3 conv to 256 → 1×1 conv to 65 = 8·8 sub-cell positions +
dustbin) and an ``ids`` head (3×3 conv to 256 → 1×1 conv to n_ids+1).
BatchNorm (eps 1e-5) runs before ReLU; the heads carry no activation.
``train=True`` (the trainers') normalizes with batch statistics and updates
the running ones (:class:`ConvBNRelu`).

``mesh`` (a ``parallel.mesh.Mesh``) runs the network as one rank of a mesh
on this rank's data shard, whole frames: when :func:`splits_rows`
the trunk convolves only this rank's rows of the height, with one halo row
from each spatial neighbour before each 3×3 conv and local pools, and the
trunk is gathered over ``spatial`` before the heads; in training the
trunk's BatchNorm statistics reduce over the ranks that hold different
pixels (the whole mesh when the height is split, else ``data``), the
heads' over ``data``.

Public layout is NHWC, as in the JAX package. Inside, convolutions run on
``channels_last`` NCHW tensors, so a ``permute(0, 2, 3, 1)`` of any
activation is a free, contiguous NHWC view — the view the decode kernels
read. Convolutions run in ``dtype`` (bf16 by default) with float32
parameters for BatchNorm; the logits come back as float32 (float64 from a
float64 module).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from deepcharuco_tpu_torch.ops import conv_epilogue
from deepcharuco_tpu_torch.parallel.collectives import all_gather, all_reduce, halo_rows


def splits_rows(mesh, height: int) -> bool:
    """Whether frames ``height`` rows high are split over the mesh's
    ``spatial`` axis: when it has more than one rank and ``height % (8·n_s)
    == 0``, so that every rank's rows stay even through the three pools."""
    if mesh is None:
        return False
    n_s = mesh.shape["spatial"]
    return n_s > 1 and height % (8 * n_s) == 0


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC → channels_last NCHW (free when ``x`` is contiguous NHWC)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """channels_last NCHW → contiguous NHWC (free for channels_last input)."""
    return x.permute(0, 2, 3, 1).contiguous()


class ConvBNRelu(nn.Module):
    """3×3 conv → BatchNorm → ReLU, then ``then``: ``"pool"`` (2×2 max-pool,
    floor), ``"up"`` (×2 nearest upsample) or ``None``. ``norm=False`` is
    the block without BatchNorm (SuperPoint's: conv with its bias → ReLU),
    on the card through the epilogue's no-norm pass
    (``conv_epilogue.bias_relu``), elsewhere the ATen chain; it has no
    ``bn`` and trains as conv → ReLU.

    ``padding=1`` is SAME, ``padding=0`` VALID. The conv runs in ``dtype``;
    BatchNorm keeps float32 parameters and normalizes in float32 before the
    result is rounded back to ``dtype``, as Flax does for a bf16 module.

    ``train=False`` normalizes with the running statistics. A bf16 block on
    a CUDA tensor with autograd off runs cuDNN's convolution without its
    bias and then one pass of ``ops.conv_epilogue`` (bias, BatchNorm, ReLU
    and ``then``), rounding where the ATen chain does; every other
    inference (the CPU, float32 and float64 modules, autograd on) runs the
    ATen chain: convolution with bias, ``F.batch_norm``, ``F.relu``, then
    :func:`pool` or :func:`up`.

    ``train=True`` normalizes with the batch's mean and *biased* variance,
    computed as Flax does (``E[x²] − E[x]²`` in float32, clipped at 0), and
    updates the running statistics as Flax's ``BatchNorm(momentum=0.9)``
    does: ``running = 0.9·running + 0.1·batch`` with the biased variance.
    Torch's own update (``F.batch_norm(training=True)``) would store the
    unbiased variance, n/(n−1) larger, so the update is written out here.
    The statistics are float32 (float64 for a float64 module).

    ``stats`` (a process group) reduces the batch statistics over its ranks,
    differentiably; every rank of it holds as many pixels, so the global
    means are the mean of the ranks' means. ``halo`` (a mesh whose height
    is split) takes one row from each spatial neighbour and convolves with
    no row padding.
    """

    MOMENTUM = 0.9

    def __init__(self, cin: int, cout: int, padding: int = 1,
                 dtype: torch.dtype = torch.bfloat16, norm: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=padding, dtype=dtype)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1) if norm else None

    def _conv(self, x, halo, bias: bool = True):
        if halo is None:
            if bias:
                return self.conv(x)
            return F.conv2d(x, self.conv.weight, None, padding=self.conv.padding)
        x = halo_rows(x, halo).contiguous(memory_format=torch.channels_last)
        return F.conv2d(x, self.conv.weight, self.conv.bias if bias else None, padding=(0, 1))

    def forward(self, x, train: bool = False, stats=None, halo=None, then=None):
        bn = self.bn
        epilogue = x.is_cuda and x.dtype == torch.bfloat16 and not torch.is_grad_enabled()
        if bn is None:
            if epilogue and not train:
                return conv_epilogue.bias_relu(self._conv(x, halo, bias=False), self.conv.bias,
                                               then)
            return FOLLOW[then](F.relu(self._conv(x, halo)))
        if train:
            return FOLLOW[then](self._train(self._conv(x, halo), stats))
        if epilogue:
            return conv_epilogue.epilogue(self._conv(x, halo, bias=False), self.conv.bias,
                                          bn.running_mean, bn.running_var, bn.weight,
                                          bn.bias, bn.eps, then)
        x = F.batch_norm(self._conv(x, halo), bn.running_mean,
                         bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)
        return FOLLOW[then](F.relu(x))

    def _train(self, x, stats):
        bn = self.bn
        xf = as_f32(x)
        mean = xf.mean(dim=(0, 2, 3))
        sq = (xf * xf).mean(dim=(0, 2, 3))
        if stats is not None:
            k = dist.get_world_size(stats)
            mean, sq = (all_reduce(torch.stack([mean, sq]), stats) / k).unbind(0)
        var = (sq - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            bn.running_mean.mul_(m).add_((1 - m) * mean)
            bn.running_var.mul_(m).add_((1 - m) * var)
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
        return F.relu(y.to(x.dtype))


def pool(x):
    return F.max_pool2d(x, 2, 2)


def up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


FOLLOW = {None: lambda x: x, "pool": pool, "up": up}


def as_f32(x: torch.Tensor) -> torch.Tensor:
    """Float32 outputs of a bf16 or float32 module; a float64 module's stay
    float64."""
    return x if x.dtype == torch.float64 else x.float()


class Detector(nn.Module):
    """(N, H, W, 1) normalized gray → ``{"loc": (N, H/8, W/8, 65),
    "ids": (N, H/8, W/8, n_ids+1)}`` float32 NHWC, or ``{"trunk":
    (N, H/8, W/8, 128)}`` in ``dtype`` under ``trunk_only=True``.

    ``norm=False`` is for ``models.SuperPoint``, the same trunk and heads
    without BatchNorm."""

    def __init__(self, n_ids: int = 16, dtype: torch.dtype = torch.bfloat16,
                 norm: bool = True):
        super().__init__()
        self.n_ids = n_ids
        self.dtype = dtype
        c1, c2, c3, c4, c5 = 64, 64, 128, 128, 256
        blk = lambda cin, cout: ConvBNRelu(cin, cout, 1, dtype, norm)
        self.conv1a, self.conv1b = blk(1, c1), blk(c1, c1)
        self.conv2a, self.conv2b = blk(c1, c2), blk(c2, c2)
        self.conv3a, self.conv3b = blk(c2, c3), blk(c3, c3)
        self.conv4a, self.conv4b = blk(c3, c4), blk(c4, c4)
        self.convPa = blk(c4, c5)
        self.convPb = nn.Conv2d(c5, 65, 1, dtype=dtype)
        self.convDa = blk(c4, c5)
        self.convDb = nn.Conv2d(c5, n_ids + 1, 1, dtype=dtype)

    def trunk(self, x, blk):
        """The four conv pairs with a 2×2 pool after each of the first three;
        ``blk(module, x, then)`` runs one block."""
        x = blk(self.conv1b, blk(self.conv1a, x), "pool")
        x = blk(self.conv2b, blk(self.conv2a, x), "pool")
        x = blk(self.conv3b, blk(self.conv3a, x), "pool")
        return blk(self.conv4b, blk(self.conv4a, x))

    def forward(self, x, train: bool = False, trunk_only: bool = False, mesh=None):
        split = splits_rows(mesh, x.shape[1])
        if split:
            h = x.shape[1] // mesh.shape["spatial"]
            x = x[:, mesh.coords[1] * h:(mesh.coords[1] + 1) * h]
        stats = None if mesh is None else mesh.world if split else mesh.data
        halo = mesh if split else None
        blk = lambda m, x, then=None: m(x, train, stats, halo, then)
        x = self.trunk(to_nchw(x.to(self.dtype)), blk)
        if split:
            x = all_gather(x, 2, mesh.spatial).contiguous(memory_format=torch.channels_last)
        if trunk_only:
            return {"trunk": to_nhwc(x)}
        stats = None if mesh is None else mesh.data
        loc = self.convPb(self.convPa(x, train, stats))
        ids = self.convDb(self.convDa(x, train, stats))
        return {"loc": to_nhwc(as_f32(loc)), "ids": to_nhwc(as_f32(ids))}

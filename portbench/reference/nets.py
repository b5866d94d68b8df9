"""The two networks in plain PyTorch, float32, NCHW, from the shipped weight
files read with numpy: the detector (eval and training forms) and RefineNet
(24 and 32 px). Written from the reference's published description (conv,
BatchNorm eps 1e-5, ReLU; 2x2 max-pools; nearest x2 upsamples) and the
weight files' layout, not from the program.

``q`` rounds every convolution's input and kernel (and, in the training
form, its output): the identity for the reference, a rounding to a lower
precision for the control.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-5
Quant = Callable[[torch.Tensor], torch.Tensor]


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def read_weights(path: str, device) -> Dict[str, torch.Tensor]:
    """A shipped ``.npz`` as {'/'-joined key: float32 tensor}; conv kernels
    turned from HWIO into OIHW."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            a = np.asarray(z[k], np.float32)
            if k.endswith("kernel") and a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def conv(x, W, name: str, pad: int, q: Quant):
    key = f"params/{name}/conv" if f"params/{name}/conv/kernel" in W else f"params/{name}"
    return F.conv2d(q(x), q(W[f"{key}/kernel"]), W[f"{key}/bias"], padding=pad)


def block(x, W, name: str, pad: int, q: Quant):
    """conv → BatchNorm on the running statistics → ReLU."""
    y = conv(x, W, name, pad, q)
    mean = W[f"batch_stats/{name}/bn/mean"][:, None, None]
    var = W[f"batch_stats/{name}/bn/var"][:, None, None]
    scale = W[f"params/{name}/bn/scale"][:, None, None]
    bias = W[f"params/{name}/bn/bias"][:, None, None]
    return F.relu((y - mean) * torch.rsqrt(var + EPS) * scale + bias)


def detector(W, x: torch.Tensor, q: Quant = identity):
    """x (N, 1, H, W) normalized gray → (loc (N, 65, H/8, W/8), ids (N,
    n_ids+1, H/8, W/8)) float32 logits."""
    for i, name in enumerate(("conv1", "conv2", "conv3", "conv4")):
        x = block(block(x, W, name + "a", 1, q), W, name + "b", 1, q)
        if i < 3:
            x = F.max_pool2d(x, 2)
    loc = conv(block(x, W, "convPa", 1, q), W, "convPb", 0, q)
    ids = conv(block(x, W, "convDa", 1, q), W, "convDb", 0, q)
    return loc, ids


def refinenet(W, p: torch.Tensor, patch_size: int, q: Quant = identity):
    """p (M, 1, P, P) normalized gray patches → (M, 64, 64) float32
    heatmaps (nearest upsampling)."""
    x = p
    for name in ("conv1a", "conv1b", "conv2a", "conv2b"):
        x = block(x, W, name, 0, q)
    x = F.max_pool2d(x, 2)
    if patch_size == 32:
        x = block(block(x, W, "conv2c", 0, q), W, "conv2d", 0, q)
    x = block(block(x, W, "conv3a", 1, q), W, "conv3b", 1, q)
    for pair in ("conv4", "conv5"):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = block(block(x, W, pair + "a", 1, q), W, pair + "b", 1, q)
    x = F.interpolate(x, scale_factor=2, mode="nearest")
    return conv(block(x, W, "convPa", 1, q), W, "convPb", 0, q)[:, 0]


def fp8(t: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled rounding to float8 e4m3 and back: the precision
    below bfloat16, as fp8 inference runs it."""
    amax = t.detach().abs().amax().float().clamp_min(1e-12)
    s = 448.0 / amax
    return ((t.float() * s).to(torch.float8_e4m3fn).float() / s).to(t.dtype)


def bf16(t: torch.Tensor) -> torch.Tensor:
    """Rounding to bfloat16 and back: the precision below float32 with
    TF32 convolutions."""
    return t.to(torch.bfloat16).to(t.dtype)


# --- the detector in training form -----------------------------------------

def detector_train(P: Dict[str, torch.Tensor], x: torch.Tensor, q: Quant = identity):
    """The detector on batch statistics (biased variance), with parameters
    named as the program's ``state_dict`` names them (``conv1a.conv.weight``,
    ``conv1a.bn.weight``, ``convPb.weight``, ...). x (N, 1, H, W). ``q``
    rounds each convolution's input, kernel and output (and, through
    autograd, their gradients)."""
    def blk(x, name):
        y = q(F.conv2d(q(x), q(P[f"{name}.conv.weight"]), P[f"{name}.conv.bias"], padding=1))
        mean = y.mean(dim=(0, 2, 3), keepdim=True)
        var = ((y - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
        y = (y - mean) * torch.rsqrt(var + EPS)
        return F.relu(y * P[f"{name}.bn.weight"][:, None, None]
                      + P[f"{name}.bn.bias"][:, None, None])

    for i, name in enumerate(("conv1", "conv2", "conv3", "conv4")):
        x = blk(blk(x, name + "a"), name + "b")
        if i < 3:
            x = F.max_pool2d(x, 2)
    loc = q(F.conv2d(q(blk(x, "convPa")), q(P["convPb.weight"]), P["convPb.bias"]))
    ids = q(F.conv2d(q(blk(x, "convDa")), q(P["convDb.weight"]), P["convDb.bias"]))
    return loc, ids

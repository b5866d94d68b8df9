"""SuperPoint (DeTone, Malisiewicz, Rabinovich, CVPRW 2018, arXiv
1712.07629), as ``cvg/LightGlue``'s ``lightglue/superpoint.py`` runs it: the
:class:`~deepcharuco_tpu_torch.models.Detector`'s trunk and heads without
BatchNorm (each 3×3 conv carries its bias and a ReLU; a 2×2 max-pool after
the first three pairs), a 65-class detection head (``convPa`` 3×3 to 256,
``convPb`` 1×1 to 65) and a descriptor head (``convDa`` 3×3 to 256,
``convDb`` 1×1 to ``descriptor_dim``). The keypoint selection and the
descriptor sampling that follow are ``ops.keypoints``.

Convolutions run in ``dtype`` (bf16 by default); on the card each block is
cuDNN's convolution and one pass of the conv epilogue's no-norm mode (the
bias, ReLU and the pool). Parameters load from the published layout
(``conv1a.weight``, ``convPb.bias``, ...) through :func:`state_from_published`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from deepcharuco_tpu_torch.models.detector import Detector, as_f32, to_nchw

BLOCKS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b",
          "convPa", "convDa")


def state_from_published(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The published state dict's keys (``conv1a.weight``) as this module
    names them (``conv1a.conv.weight``: a block holds its conv)."""
    out = {}
    for k, v in sd.items():
        name, leaf = k.split(".", 1)
        out[f"{name}.conv.{leaf}" if name in BLOCKS else k] = v
    return out


class SuperPoint(Detector):
    """(N, H, W) gray in [0, 1] → (scores' logits (N, 65, H/8, W/8),
    dense descriptors (N, descriptor_dim, H/8, W/8)), both float32
    channels_last; H and W multiples of 8."""

    def __init__(self, descriptor_dim: int = 256, dtype: torch.dtype = torch.bfloat16):
        # convDb is n_ids + 1 wide; SuperPoint reads no n_ids
        super().__init__(n_ids=descriptor_dim - 1, dtype=dtype, norm=False)

    def forward(self, gray: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # from (N, H, W, 1): strides with C's 1, which cuDNN reads as NHWC and
        # answers with a channels_last output, as the epilogue takes it
        x = to_nchw(gray.to(self.dtype)[..., None])
        x = self.trunk(x, lambda m, x, then=None: m(x, then=then))
        return as_f32(self.convPb(self.convPa(x))), as_f32(self.convDb(self.convDa(x)))

"""Static-shape corner decode (``deepcharuco_tpu.ops.decode``).

Decode emits fixed-capacity, id-indexed arrays: one slot per corner id plus a
validity mask. When several cells claim one id, the cell with the highest
ids-head confidence wins and equal confidences go to the lowest row-major
cell. Coordinates are ``x = 8·col + pix % 8``, ``y = 8·row + pix // 8`` with
``pix`` the loc-head argmax in the 8×8 cell; channel 64 (loc) and
``n_ids`` (ids) are the dustbins.

:func:`pred_to_keypoints` is the decode kernel's wrapper
(:mod:`deepcharuco_tpu_torch.ops.cuda_decode`): the kernel on a CUDA tensor,
its plain version on a CPU tensor. Both write (0, 0) into invalid slots,
where :func:`label_to_keypoints` (like the JAX package's) holds cell 0's
position; compare valid slots only.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepcharuco_tpu_torch.ops import cuda_decode


def pred_argmax(loc_hat: torch.Tensor, ids_hat: torch.Tensor, dust_bin_ids: int):
    """Channel argmax of both heads with dustbin suppression (NHWC in,
    (N, Hc, Wc) int32 out, first-max semantics)."""
    loc_argmax = torch.argmax(loc_hat, dim=-1).to(torch.int32)
    ids_argmax = torch.argmax(ids_hat, dim=-1).to(torch.int32)
    ids_argmax = torch.where(loc_argmax == 64,
                             torch.full_like(ids_argmax, dust_bin_ids), ids_argmax)
    return loc_argmax, ids_argmax


def label_to_keypoints(loc: torch.Tensor, ids: torch.Tensor, dust_bin_ids: int,
                       scores: Optional[torch.Tensor] = None):
    """(N, Hc, Wc) class-index maps → keypoints (N, n_ids, 2) float32 and
    valid (N, n_ids) bool. ``scores`` break duplicate-id ties (highest wins,
    then lowest cell); without them the last row-major cell wins."""
    n, hc, wc = loc.shape
    m = hc * wc
    loc_f = loc.reshape(n, m).long()
    ids_f = ids.reshape(n, m)
    mask = ids_f != dust_bin_ids
    if scores is None:
        score_f = torch.arange(m, dtype=torch.float32,
                               device=loc.device).expand(n, m)
    else:
        score_f = scores.reshape(n, m).float()

    id_range = torch.arange(dust_bin_ids, device=loc.device, dtype=ids_f.dtype)
    claims = (ids_f[:, None, :] == id_range[None, :, None]) & mask[:, None, :]
    sel = torch.where(claims, score_f[:, None, :],
                      torch.tensor(float("-inf"), device=loc.device))
    best_cell = torch.argmax(sel, dim=-1)                     # (N, n_ids)
    valid = claims.any(dim=-1)
    pix = torch.gather(loc_f, 1, best_cell)
    x = 8 * (best_cell % wc) + pix % 8
    y = 8 * (best_cell // wc) + pix // 8
    return torch.stack([x, y], dim=-1).float(), valid


def pred_to_keypoints(loc_hat: torch.Tensor, ids_hat: torch.Tensor,
                      dust_bin_ids: int, min_margin: Optional[float] = None):
    """Model heads → fixed-capacity keypoints. ``min_margin`` (off by
    default) requires the winning id logit to beat the ids dustbin logit by
    at least that much."""
    return cuda_decode.decode(loc_hat, ids_hat, dust_bin_ids, min_margin=min_margin)


def heatmap_argmax2d(heat: torch.Tensor) -> torch.Tensor:
    """Flat first-max argmax of (..., H, W) heatmaps → (..., 2) float32 (x, y)."""
    h, w = heat.shape[-2], heat.shape[-1]
    idx = torch.argmax(heat.reshape(*heat.shape[:-2], h * w), dim=-1)
    return torch.stack([idx % w, idx // w], dim=-1).float()


def refine_keypoints(heat: torch.Tensor, keypoints: torch.Tensor) -> torch.Tensor:
    """RefineNet heatmap decode: ``keypoint + (argmax − 32)/8``.

    heat: (..., 64, 64) or (..., 64, 64, 1); keypoints: (..., 2)."""
    if heat.shape[-1] == 1 and heat.ndim >= 3 and heat.shape[-2] == 64:
        heat = heat[..., 0]
    return (heatmap_argmax2d(heat) - 32.0) / 8.0 + keypoints

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

:func:`pred_to_keypoints_topk` is the duplicate-preserving decode (up to
``capacity`` cells per id, plain tensor ops on either device). The
refinement decodes are :func:`refine_keypoints` (hard argmax),
:func:`refine_keypoints_soft` (softmax expectation) and
:func:`refine_keypoints_offset` (the offset branch's regression).
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
    wc = loc.shape[2]
    loc_f, claims, sel = _claims(loc, ids, dust_bin_ids, scores)
    best_cell = torch.argmax(sel, dim=-1)                     # (N, n_ids)
    valid = claims.any(dim=-1)
    pix = torch.gather(loc_f, 1, best_cell)
    x = 8 * (best_cell % wc) + pix % 8
    y = 8 * (best_cell // wc) + pix // 8
    return torch.stack([x, y], dim=-1).float(), valid


def _claims(loc, ids, dust_bin_ids, scores):
    """Flat maps and the (N, n_ids, M) table of each cell's score where it
    claims the id, −inf elsewhere."""
    n, hc, wc = loc.shape
    m = hc * wc
    loc_f = loc.reshape(n, m).long()
    ids_f = ids.reshape(n, m)
    if scores is None:
        score_f = torch.arange(m, dtype=torch.float32,
                               device=loc.device).expand(n, m)
    else:
        score_f = scores.reshape(n, m).float()
    id_range = torch.arange(dust_bin_ids, device=loc.device, dtype=ids_f.dtype)
    claims = (ids_f[:, None, :] == id_range[None, :, None]) & \
        (ids_f != dust_bin_ids)[:, None, :]
    sel = torch.where(claims, score_f[:, None, :], float("-inf"))
    return loc_f, claims, sel


def label_to_keypoints_topk(loc: torch.Tensor, ids: torch.Tensor, dust_bin_ids: int,
                            capacity: int = 4, scores: Optional[torch.Tensor] = None):
    """Duplicate-preserving decode: up to ``capacity`` cells per corner id.

    Returns keypoints (N, n_ids, capacity, 2) float32, slot ``[*, k, j]`` the
    j-th highest-score cell claiming id k with equal scores in ascending cell
    order (a stable descending sort, which is how ``jax.lax.top_k`` orders
    them), and valid (N, n_ids, capacity) bool. Slot 0 is
    :func:`label_to_keypoints`'s winner."""
    wc = loc.shape[2]
    loc_f, _, sel = _claims(loc, ids, dust_bin_ids, scores)
    top_scores, top_cells = torch.sort(sel, dim=-1, descending=True, stable=True)
    top_scores, top_cells = top_scores[..., :capacity], top_cells[..., :capacity]
    valid = torch.isfinite(top_scores)
    pix = torch.gather(loc_f[:, None, :].expand(-1, dust_bin_ids, -1), 2, top_cells)
    x = 8 * (top_cells % wc) + pix % 8
    y = 8 * (top_cells // wc) + pix // 8
    return torch.stack([x, y], dim=-1).float(), valid


def pred_to_keypoints_topk(loc_hat: torch.Tensor, ids_hat: torch.Tensor,
                           dust_bin_ids: int, capacity: int = 4,
                           min_margin: Optional[float] = None):
    """Model heads → duplicate-preserving keypoints (see
    :func:`label_to_keypoints_topk`)."""
    loc_argmax, ids_argmax = pred_argmax(loc_hat, ids_hat, dust_bin_ids)
    conf = ids_hat.amax(dim=-1)
    if min_margin is not None:
        margin = conf - ids_hat[..., dust_bin_ids]
        ids_argmax = torch.where(margin >= min_margin, ids_argmax,
                                 torch.full_like(ids_argmax, dust_bin_ids))
    return label_to_keypoints_topk(loc_argmax, ids_argmax, dust_bin_ids,
                                   capacity=capacity, scores=conf)


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


def soft_argmax_2d(heat: torch.Tensor, temperature: float = 30.0) -> torch.Tensor:
    """Softmax-expectation position of (..., H, W[, 1]) heatmaps → (..., 2)
    float32 (x, y) in heatmap-grid units."""
    if heat.shape[-1] == 1 and heat.ndim >= 3:
        heat = heat[..., 0]
    h, w = heat.shape[-2], heat.shape[-1]
    p = torch.softmax(heat.reshape(*heat.shape[:-2], h * w) * temperature, dim=-1)
    p = p.reshape(*heat.shape[:-2], h, w)
    xs = torch.arange(w, dtype=torch.float32, device=heat.device)
    ys = torch.arange(h, dtype=torch.float32, device=heat.device)
    ex = (p.sum(dim=-2) * xs).sum(dim=-1)
    ey = (p.sum(dim=-1) * ys).sum(dim=-1)
    return torch.stack([ex, ey], dim=-1)


def refine_keypoints_soft(heat: torch.Tensor, keypoints: torch.Tensor,
                          temperature: float = 30.0) -> torch.Tensor:
    """Soft-argmax heatmap decode: ``keypoint + (E[position] − 32)/8``,
    continuous where :func:`refine_keypoints` snaps to the 1/8-px grid."""
    return (soft_argmax_2d(heat, temperature) - 32.0) / 8.0 + keypoints


def refine_keypoints_offset(offsets: torch.Tensor,
                            keypoints: torch.Tensor) -> torch.Tensor:
    """Offset-head decode: the branch regresses the corner's (dx, dy) in
    image px from the patch center, so refinement is an add."""
    return keypoints + offsets

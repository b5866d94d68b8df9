"""Geometry-consistent corner decode (``deepcharuco_tpu.ops.geom``), opt-in.

The one-slot decode keeps, per corner id, the highest-confidence cell that
claims it. On self-similar views a wrong cell can outscore the true one and
take the slot. The board is planar, so all true corners relate to the board
plane by one homography, while a decoy sits a full board cell (≥ 8 px) from
its id's true position: :func:`reselect_by_homography` runs on the
duplicate-preserving capacity-K decode, fits a plane→image homography (a
fixed-shape RANSAC over 4-candidate subsets seeds fixed trim-refit rounds)
and selects per id the highest-score candidate within ``tol_px`` of the
homography's prediction. Ids with no consistent candidate decode as
invalid; a refit-RMS gate falls the frame back to the parity decode when no
single homography explains the final selection.
:func:`fill_from_homography` then predicts undetected ids from the detected
ones.

Batch-first plain tensor ops on either device: every function takes any
leading dimensions (frames), shares ``board_xy`` between them, loops over no
frame and never synchronises with the host. The only randomness is the
RANSAC seed's Gumbel noise, two tables that do not depend on the data:
:func:`default_noise` draws them from a seeded ``torch.Generator`` (the
decode stays deterministic), and every function takes ``noise`` so that
tables drawn elsewhere can be passed in.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from deepcharuco_tpu_torch.ops.decode import (label_to_keypoints_topk,
                                              pred_to_keypoints_topk)
from deepcharuco_tpu_torch.pnp.solve import _dlt_homography

Noise = Tuple[torch.Tensor, torch.Tensor]


@functools.lru_cache(maxsize=16)
def _default_noise(n_subsets: int, n_ids: int, capacity: int, device: torch.device) -> Noise:
    gen = torch.Generator().manual_seed(0)
    gumbel = lambda *shape: -torch.log(-torch.log(
        torch.rand(shape, generator=gen).clamp_min(1e-20)))
    return (gumbel(n_subsets, n_ids).to(device),
            gumbel(n_subsets, n_ids, capacity).to(device))


def default_noise(n_subsets: int, n_ids: int, capacity: int, device="cpu") -> Noise:
    """The seed's Gumbel tables ``(g (S, n_ids), gs (S, n_ids, C))`` from a
    ``torch.Generator`` with seed 0: the same tables on every call."""
    return _default_noise(n_subsets, n_ids, capacity, torch.device(device))


def _apply_homography(H: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) plane→image homographies applied to plane points (M, 2)
    or (..., M, 2) → (..., M, 2). Products and sums in float32."""
    p = (xy[..., :, None, 0] * H[..., None, :, 0] + xy[..., :, None, 1] * H[..., None, :, 1]
         + H[..., None, :, 2])
    z = p[..., 2:]
    return p[..., :2] / torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))


def _ransac_seed(kp_topk: torch.Tensor, valid_topk: torch.Tensor, board_xy: torch.Tensor,
                 n_subsets: int, tol: float, noise: Optional[Noise] = None):
    """Consensus-best homography from minimal 4-id subsets (fixed shape).

    ``n_subsets`` Gumbel top-4 draws of distinct ids that have any valid
    candidate, each paired with a uniformly drawn valid slot; an exact
    4-point DLT per subset, all subsets of all frames as one batch; consensus
    counted per id as any candidate within ``tol`` of the subset's
    projection, the mean inlier residual breaking ties. All slots are
    sampled, not only slot 0: displaced true corners and override candidates
    can seed the fit, and they vote. With −1e9 added, ids without a candidate
    tie; a stable descending sort orders them by index, as ``jax.lax.top_k``
    does. A degenerate subset (collinear points, NaN H) scores zero inliers.

    kp_topk (..., n_ids, C, 2), valid_topk (..., n_ids, C), board_xy
    (n_ids, 2). Returns (H_best (..., 3, 3), n_inliers_best (...,))."""
    n_ids, cap = valid_topk.shape[-2:]
    lead = valid_topk.shape[:-2]
    g, gs = noise if noise is not None else default_noise(n_subsets, n_ids, cap,
                                                          kp_topk.device)
    if g.shape != (n_subsets, n_ids) or gs.shape != (n_subsets, n_ids, cap):
        raise ValueError(f"noise tables {tuple(g.shape)}, {tuple(gs.shape)} do not fit "
                         f"{n_subsets} subsets of {n_ids} ids × {cap} slots")
    g, gs = g.to(kp_topk.device, torch.float32), gs.to(kp_topk.device, torch.float32)
    masked = lambda m: torch.where(m, 0.0, -1e9)
    any_val = valid_topk.any(dim=-1)
    ids4 = torch.sort(g + masked(any_val)[..., None, :], dim=-1, descending=True,
                      stable=True).indices[..., :4]                       # (..., S, 4)
    slots = torch.argmax(gs + masked(valid_topk)[..., None, :, :], dim=-1)  # (..., S, n_ids)
    slot4 = torch.gather(slots, -1, ids4)
    flat = (ids4 * cap + slot4).reshape(*lead, n_subsets * 4, 1).expand(*lead, -1, 2)
    img4 = torch.gather(kp_topk.reshape(*lead, n_ids * cap, 2), -2, flat)
    img4 = img4.reshape(*lead, n_subsets, 4, 2)
    Hs = _dlt_homography(board_xy[ids4], img4, torch.ones_like(img4[..., 0]))
    proj = _apply_homography(Hs, board_xy)                                # (..., S, n_ids, 2)
    d = torch.linalg.vector_norm(kp_topk[..., None, :, :, :] - proj[..., None, :], dim=-1)
    inf = torch.full_like(d, float("inf"))
    dmin = torch.where(valid_topk[..., None, :, :], d, inf).amin(dim=-1)  # (..., S, n_ids)
    dmin = torch.where(torch.isfinite(dmin), dmin, torch.full_like(dmin, 1e9))
    inl = dmin <= tol
    score = inl.sum(dim=-1).float() - 1e-3 * dmin.clamp_max(tol).sum(dim=-1) / tol
    best = torch.argmax(score, dim=-1)                                    # (...,), first max
    H_best = torch.gather(Hs, -3, best[..., None, None, None].expand(*lead, 1, 3, 3))
    n_best = torch.gather(inl.sum(dim=-1), -1, best[..., None])
    return H_best[..., 0, :, :], n_best[..., 0]


def reselect_by_homography(kp_topk: torch.Tensor, valid_topk: torch.Tensor,
                           board_xy: torch.Tensor, tol_px: float = 4.0, iters: int = 3,
                           min_points: int = 6, max_rms_px: float = 1.5,
                           ransac_subsets: int = 32, noise: Optional[Noise] = None):
    """Choose, per id, the candidate consistent with the board.

    Parameters
    ----------
    kp_topk : (..., n_ids, C, 2) candidate pixel positions, slot 0 the
        highest ids-head score (``label_to_keypoints_topk`` order).
    valid_topk : (..., n_ids, C) candidate validity.
    board_xy : (n_ids, 2) the ids' inner-corner coordinates in any planar
        board parametrization.
    tol_px : final consistency tolerance; decoys sit ≥ 8 px from the id's
        true position.
    iters : trim-refit rounds; tolerances anneal toward ``tol_px``.
    min_points : with fewer ids holding any candidate the homography is
        unreliable and the plain top-1 decode comes back unchanged.
    max_rms_px : gate on the final selection: one more fit to it, and if
        its masked RMS exceeds this the frame falls back to the parity
        decode (a churning fit can end on a selection that no single
        homography explains).
    ransac_subsets : seed the loop with the consensus-best 4-point
        homography (:func:`_ransac_seed`); 0 seeds with the all-points
        least-squares fit.
    noise : the seed's Gumbel tables (:func:`default_noise` when None).

    Returns keypoints (..., n_ids, 2) float32 and valid (..., n_ids) bool.
    """
    board_xy = board_xy.to(kp_topk.device, torch.float32)
    sel0 = kp_topk[..., 0, :]
    val0 = valid_topk[..., 0]
    enough = valid_topk.any(dim=-1).sum(dim=-1) >= min_points
    sel, w = sel0, val0.float()
    any_elig = val0
    if ransac_subsets:
        H_seed, _ = _ransac_seed(kp_topk, valid_topk, board_xy, ransac_subsets, tol_px, noise)
    # annealed tolerances: generous while the fit still holds decoys
    for k in range(iters):
        tol = tol_px * 2.0 ** (iters - 1 - k)
        H = H_seed if (k == 0 and ransac_subsets) else _dlt_homography(board_xy, sel, w)
        proj = _apply_homography(H, board_xy)
        d = torch.linalg.vector_norm(kp_topk - proj[..., None, :], dim=-1)
        eligible = valid_topk & (d <= tol)
        any_elig = eligible.any(dim=-1)
        # first eligible slot = the highest-score eligible one; 0 when none
        slot = torch.argmax(eligible.to(torch.uint8), dim=-1)
        picked = torch.gather(kp_topk, -2, slot[..., None, None].expand(*slot.shape, 1, 2))
        sel = torch.where(any_elig[..., None], picked[..., 0, :], sel0)
        w = any_elig.float()

    # A degenerate fit shows as an (almost) empty consistent set, a churned
    # one as a selection that one homography does not explain: refit once and
    # gate on the residual; either way fall back to the parity decode.
    proj = _apply_homography(_dlt_homography(board_xy, sel, w), board_xy)
    resid2 = ((proj - sel) ** 2).sum(dim=-1)
    n_sel = w.sum(dim=-1).clamp_min(1.0)
    rms = torch.sqrt(torch.where(any_elig, resid2, torch.zeros_like(resid2)).sum(dim=-1)
                     / n_sel)
    fit_ok = (any_elig.sum(dim=-1) >= min_points) & torch.isfinite(rms) & (rms <= max_rms_px)
    use = enough & fit_ok
    keypoints = torch.where((use[..., None] & any_elig)[..., None], sel, sel0)
    valid = torch.where(use[..., None], any_elig, val0)
    return keypoints, valid


def fill_from_homography(keypoints: torch.Tensor, valid: torch.Tensor,
                         board_xy: torch.Tensor, frame_hw: Tuple[int, int],
                         min_points: int = 8, max_rms_px: float = 1.5,
                         min_spread_px: float = 3.0, max_mahal: float = 3.0):
    """Predict the positions of undetected ids from the detected ones.

    The homography is refit from the detected corners and every invalid id
    inside the frame is filled at its projected position (the classical
    ``interpolateCornersCharuco`` recovery); the caller's RefineNet pass
    then refines filled and detected corners alike. Nothing is filled unless

    * at least ``min_points`` ids are detected,
    * the fit's masked RMS residual on the detected corners is ≤
      ``max_rms_px``,
    * the smaller principal standard deviation of the detected
      constellation is ≥ ``min_spread_px`` (near-collinear points admit
      low-residual fits that extrapolate arbitrarily), and
    * per id, the projected position lies within ``max_mahal`` standard
      deviations (Mahalanobis, under the constellation's covariance) of the
      constellation's centroid.

    keypoints (..., n_ids, 2), valid (..., n_ids). Returns (centers
    (..., n_ids, 2), valid_out, filled): ``centers`` are integer patch
    centers (half rounds to even; detected ids keep their decoded position)
    and ``valid_out = valid | filled``."""
    board_xy = board_xy.to(keypoints.device, torch.float32)
    w_mask = valid.float()
    n = w_mask.sum(dim=-1).clamp_min(1.0)
    proj = _apply_homography(_dlt_homography(board_xy, keypoints, w_mask), board_xy)
    h, w = frame_hw
    inb = ((proj[..., 0] >= 0) & (proj[..., 0] <= w - 1)
           & (proj[..., 1] >= 0) & (proj[..., 1] <= h - 1))
    enough = valid.sum(dim=-1) >= min_points

    zero = torch.zeros((), dtype=keypoints.dtype, device=keypoints.device)
    resid2 = ((proj - keypoints) ** 2).sum(dim=-1)
    rms = torch.sqrt(torch.where(valid, resid2, zero).sum(dim=-1) / n)
    mean_kp = torch.where(valid[..., None], keypoints, zero).sum(dim=-2) / n[..., None]
    cen = torch.where(valid[..., None], keypoints - mean_kp[..., None, :], zero)
    cxx = (cen[..., 0] * cen[..., 0]).sum(dim=-1) / n
    cyy = (cen[..., 1] * cen[..., 1]).sum(dim=-1) / n
    cxy = (cen[..., 0] * cen[..., 1]).sum(dim=-1) / n
    tr = cxx + cyy
    det = cxx * cyy - cxy * cxy
    min_eig = tr / 2.0 - torch.sqrt((tr * tr / 4.0 - det).clamp_min(0.0))
    fit_ok = (rms <= max_rms_px) & (min_eig >= min_spread_px * min_spread_px)

    # extrapolation-leverage gate
    dp = proj - mean_kp[..., None, :]
    safe_det = torch.where(det.abs() > 1e-9, det, torch.full_like(det, 1e-9))[..., None]
    cxx, cyy, cxy = cxx[..., None], cyy[..., None], cxy[..., None]
    mahal2 = (dp[..., 0] * (cyy * dp[..., 0] - cxy * dp[..., 1])
              + dp[..., 1] * (cxx * dp[..., 1] - cxy * dp[..., 0])) / safe_det
    near = mahal2 <= max_mahal * max_mahal

    filled = ~valid & inb & (enough & fit_ok)[..., None] & near
    centers = torch.where(valid[..., None], keypoints, torch.round(proj))
    return centers, valid | filled, filled


def pred_to_keypoints_geom(loc_hat: torch.Tensor, ids_hat: torch.Tensor, dust_bin_ids: int,
                           board_xy: torch.Tensor, capacity: int = 3, tol_px: float = 4.0,
                           iters: int = 3, min_points: int = 6,
                           min_margin: Optional[float] = None, loc_override: bool = True,
                           override_capacity: int = 2, max_rms_px: float = 1.5,
                           ransac_subsets: int = 32, noise: Optional[Noise] = None):
    """Batched heads → geometry-reselected one-slot keypoints, shaped as
    ``pred_to_keypoints``'s ((N, n_ids, 2), (N, n_ids)); see
    :func:`reselect_by_homography`.

    ``loc_override`` also admits loc-gated cells as low-priority
    candidates: cells whose loc head argmaxes the dustbin while the ids head
    names a corner, which the parity decode drops. They are positioned at
    the loc head's best non-dustbin bin and appended after the gated claims
    (``C = capacity + override_capacity`` slots per id), so they win only
    where a gated candidate is geometrically inconsistent or absent."""
    kp_k, val_k = pred_to_keypoints_topk(loc_hat, ids_hat, dust_bin_ids, capacity=capacity,
                                         min_margin=min_margin)
    if loc_override:
        loc_argmax = torch.argmax(loc_hat, dim=-1)
        pos64 = torch.argmax(loc_hat[..., :64], dim=-1).to(torch.int32)
        ids_raw = torch.argmax(ids_hat, dim=-1).to(torch.int32)
        conf = ids_hat.amax(dim=-1)
        dust = torch.full_like(ids_raw, dust_bin_ids)
        if min_margin is not None:
            margin = conf - ids_hat[..., dust_bin_ids]
            ids_raw = torch.where(margin >= min_margin, ids_raw, dust)
        # only the cells that the parity decode dropped for the loc gate alone
        ids_ov = torch.where(loc_argmax == 64, ids_raw, dust)
        kp_o, val_o = label_to_keypoints_topk(pos64, ids_ov, dust_bin_ids,
                                              capacity=override_capacity, scores=conf)
        kp_k = torch.cat([kp_k, kp_o], dim=2)
        val_k = torch.cat([val_k, val_o], dim=2)
    return reselect_by_homography(kp_k, val_k, board_xy, tol_px=tol_px, iters=iters,
                                  min_points=min_points, max_rms_px=max_rms_px,
                                  ransac_subsets=ransac_subsets, noise=noise)

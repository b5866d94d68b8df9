"""Outlier-robust planar PnP with a fixed shape
(``deepcharuco_tpu.pnp.ransac``): S minimal hypotheses per frame, all in
one batch.

1. draw S random 4-point subsets of the valid detections,
2. homography-init pose per subset (no LM),
3. count inliers by reprojection error,
4. LM-refine from the best hypothesis on its inlier set.

The draw takes an explicit ``torch.Generator``. The scoring,
:func:`solve_pnp_ransac_from_weights`, takes the subsets as 0/1 weights
(..., S, N), so that subsets drawn elsewhere can be scored.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepcharuco_tpu_torch.pnp.projection import (_dist_terms, project_points,
                                                  rodrigues_inverse,
                                                  undistort_normalize)
from deepcharuco_tpu_torch.pnp.solve import (_dlt_homography, _finish, _lm_refine,
                                             _pose_from_homography)


def sample_weights(valid: torch.Tensor, n_hypotheses: int = 16, subset: int = 4,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """S random ``subset``-point subsets of each frame's valid points as 0/1
    weights (..., S, N): Gumbel-top-k over the validity mask, duplicate-free.
    With fewer than ``subset`` valid points a subset is all of them."""
    shape = valid.shape[:-1] + (n_hypotheses, valid.shape[-1])
    u = torch.rand(shape, generator=generator,
                   device=generator.device if generator is not None else valid.device)
    g = -torch.log(-torch.log(u.clamp_min(1e-20))).to(valid.device)
    v = valid[..., None, :]
    score = torch.where(v, g, float("-inf"))
    thresh = torch.sort(score, dim=-1).values[..., -subset, None]
    return ((score >= thresh) & v).float()


@torch.no_grad()
def solve_pnp_ransac_from_weights(object_points, image_points, valid, K, dist,
                                  weights, inlier_px: float = 3.0, iters: int = 20):
    """Score the hypotheses given as subset weights (..., S, N) and refine
    the best one on its inliers. Returns (ok, rvec, tvec, reproj_rms,
    inlier (..., N) bool), shaped as :func:`solve_pnp`'s."""
    object_points = object_points.float()
    K = K.float()
    dist = _dist_terms(dist, image_points.device)
    n_valid = valid.float().sum(dim=-1)
    ok = n_valid >= 4
    v2 = valid[..., None]
    safe = torch.stack([K[0, 2], K[1, 2]]).to(image_points.dtype)
    image_points = torch.where(v2, image_points, safe)
    xn = undistort_normalize(image_points, K, dist)

    # every hypothesis: pose from its subset's homography, inliers among all
    R0, t0 = _pose_from_homography(
        _dlt_homography(object_points[:, :2], xn[..., None, :, :].expand(
            *weights.shape, 2), weights))
    rvec0 = rodrigues_inverse(R0)                                  # (..., S, 3)
    proj = project_points(object_points, rvec0, t0, K, dist)       # (..., S, N, 2)
    err = torch.linalg.vector_norm(proj - image_points[..., None, :, :], dim=-1)
    inl = valid[..., None, :] & (err < inlier_px) & torch.isfinite(err)
    counts = inl.sum(dim=-1)                                       # (..., S)
    best = counts.argmax(dim=-1, keepdim=True)                     # first maximum
    pick = lambda t: torch.gather(
        t, -2, best[..., None].expand(*best.shape, t.shape[-1]))[..., 0, :]
    # no hypothesis with ≥ 4 inliers → fall back to all valid points
    use_all = torch.gather(counts, -1, best) < 4
    inlier = torch.where(use_all, valid, pick(inl))

    w = inlier.float()
    rvec, tvec, cost = _lm_refine(object_points, image_points, w, K, dist,
                                  pick(rvec0), pick(t0), iters=iters)
    return _finish(ok, rvec, tvec, cost, w.sum(dim=-1)) + (inlier,)


def solve_pnp_ransac(object_points, image_points, valid, K, dist,
                     generator: Optional[torch.Generator] = None,
                     inlier_px: float = 3.0, n_hypotheses: int = 16,
                     iters: int = 20):
    """Robust planar PnP at fixed capacity, for one frame or a batch: the
    contract of :func:`~deepcharuco_tpu_torch.pnp.solve.solve_pnp` plus a
    generator for the subsets; also returns the final inlier mask."""
    weights = sample_weights(valid, n_hypotheses, generator=generator)
    return solve_pnp_ransac_from_weights(object_points, image_points, valid, K, dist,
                                         weights, inlier_px=inlier_px, iters=iters)


def solve_pnp_ransac_batch(object_points, image_points, valid, K, dist,
                           generator: Optional[torch.Generator] = None,
                           inlier_px: float = 3.0, n_hypotheses: int = 16,
                           iters: int = 20):
    """:func:`solve_pnp_ransac` over a leading frame dimension: the same
    function, which is batch-first and draws every frame's subsets at once."""
    return solve_pnp_ransac(object_points, image_points, valid, K, dist, generator,
                            inlier_px=inlier_px, n_hypotheses=n_hypotheses, iters=iters)

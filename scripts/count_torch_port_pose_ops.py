#!/usr/bin/env python3
"""Count the operations of the port's plain pose tail, on the CPU.

On the card the pose tail is one kernel launch (``csrc/pnp.cu``); this
counts what its plain version (``pnp.solve_pnp_plain``) would launch there.
Runs ``pnp.solve_pnp_batch`` on CPU tensors for 256 synthetic views under
``torch.profiler`` and prints how many ``aten`` calls it makes, all of them
and those that are not views or allocations (nested calls included, so the
second figure is an upper estimate of the kernels the same call launches on
a card), for the whole solver and for its parts, and the same two counts
for the geometry decode (``ops.geom``: ``pred_to_keypoints_geom`` on random
logits of 256 frames, its RANSAC seed, and the fill). A count, not a time:
the times come from ``chip_smoke.py`` on the card.

Run from anywhere: ``python3 scripts/count_torch_port_pose_ops.py``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deepcharuco_tpu_torch.board import inner_corner_object_points  # noqa: E402
from deepcharuco_tpu_torch.ops import geom as G  # noqa: E402
from deepcharuco_tpu_torch.pnp import projection as P  # noqa: E402
from deepcharuco_tpu_torch.pnp import smallmath as M  # noqa: E402
from deepcharuco_tpu_torch.pnp import solve as S  # noqa: E402

N = 256
# calls that launch nothing on a card: views, allocations, bookkeeping
NO_KERNEL = {
    "aten::select", "aten::slice", "aten::as_strided", "aten::unsqueeze", "aten::expand",
    "aten::view", "aten::reshape", "aten::transpose", "aten::unbind", "aten::_unsafe_view",
    "aten::permute", "aten::squeeze", "aten::alias", "aten::diagonal", "aten::empty",
    "aten::empty_like", "aten::empty_strided", "aten::result_type", "aten::resize_",
    "aten::flatten", "aten::expand_as", "aten::narrow", "aten::detach", "aten::lift_fresh",
    "aten::t", "aten::numpy_T", "aten::movedim", "aten::to", "aten::contiguous",
}


def count(fn):
    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = prof.key_averages()
    return (sum(e.count for e in events),
            sum(e.count for e in events if e.key not in NO_KERNEL))


def main() -> int:
    obj = torch.from_numpy(inner_corner_object_points(5, 5, 0.01))
    K = torch.tensor([[420.0, 0, 160], [0, 420.0, 120], [0, 0, 1]])
    dist = P._dist12(torch.tensor([0.05, -0.02, 0.001, -0.0015, 0.01]))
    rng = np.random.default_rng(0)
    rvec = torch.from_numpy(rng.normal(scale=0.4, size=(N, 3)).astype(np.float32))
    tvec = torch.from_numpy(rng.normal(scale=0.02, size=(N, 3)).astype(np.float32))
    tvec[:, 2] += 0.3
    img = P.project_points(obj, rvec, tvec, K, dist)
    valid = torch.ones(N, 16, dtype=torch.bool)
    w = valid.float()
    xn = P.undistort_normalize(img, K, dist)
    H = S._dlt_homography(obj[:, :2], xn, w)
    A = torch.randn(N, 6, 6)
    A = A @ A.transpose(-1, -2) + torch.eye(6)
    b = torch.randn(N, 6)
    lm = lambda iters: S._lm_refine(obj, img, w, K, dist, rvec, tvec, iters=iters)
    parts = {
        f"solve_pnp_batch, {N} frames, 20 iterations": lambda: S.solve_pnp_batch(
            obj, img, valid, K, dist),
        "undistort_normalize": lambda: P.undistort_normalize(img, K, dist),
        "_dlt_homography": lambda: S._dlt_homography(obj[:, :2], xn, w),
        "_pose_from_homography": lambda: S._pose_from_homography(H),
        "_lm_refine, 1 iteration": lambda: lm(1),
        "_lm_refine, 2 iterations": lambda: lm(2),
        "project_points_jacobian": lambda: P.project_points_jacobian(obj, rvec, tvec, K, dist),
        "cholesky_solve 6×6": lambda: M.cholesky_solve(A, b),
    }
    loc = torch.from_numpy(rng.normal(size=(N, 30, 40, 65)).astype(np.float32))
    ids = torch.from_numpy(rng.normal(size=(N, 30, 40, 17)).astype(np.float32))
    xy = obj[:, :2]
    kp_k = img[:, :, None, :].expand(N, 16, 5, 2).contiguous()
    val_k = torch.ones(N, 16, 5, dtype=torch.bool)
    parts.update({
        f"pred_to_keypoints_geom, {N} frames": lambda: G.pred_to_keypoints_geom(
            loc, ids, 16, xy),
        "_ransac_seed, 32 subsets": lambda: G._ransac_seed(kp_k, val_k, xy, 32, 4.0),
        "fill_from_homography": lambda: G.fill_from_homography(img, valid, xy, (240, 320)),
    })
    for name, fn in parts.items():
        total, kernels = count(fn)
        print(f"{name}: {total} aten calls, {kernels} that are not views or allocations")
    return 0


if __name__ == "__main__":
    sys.exit(main())

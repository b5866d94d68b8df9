"""Batched planar PnP on the device (``deepcharuco_tpu.pnp``): the camera
model, small fixed-size linear algebra, the DLT + Levenberg–Marquardt solver
and its RANSAC variant. Plain float32 tensor ops, batch-first: every
function takes any number of leading batch dimensions where the JAX package
relies on ``vmap``. On the card :func:`solve_pnp` is one kernel launch
(``csrc/pnp.cu``)."""

from deepcharuco_tpu_torch.pnp.projection import (
    rodrigues,
    rodrigues_inverse,
    distort,
    undistort_normalize,
    project_points,
)
from deepcharuco_tpu_torch.pnp.solve import solve_pnp, solve_pnp_batch, solve_pnp_plain

__all__ = [
    "rodrigues",
    "rodrigues_inverse",
    "distort",
    "undistort_normalize",
    "project_points",
    "solve_pnp",
    "solve_pnp_batch",
    "solve_pnp_plain",
]

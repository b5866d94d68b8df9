"""Batched planar PnP: masked DLT homography init + Levenberg–Marquardt
(``deepcharuco_tpu.pnp.solve``), on the device with the rest of the pipeline.

Static shapes: all point arrays are fixed capacity (n_ids) with a validity
mask, and fewer than 4 valid points, or a degenerate constellation, end in
``ok=False``. Batch-first: image points and masks carry any leading
dimensions (frames; frames × hypotheses in the RANSAC variant), the object
points and the camera are shared. The two LM starts of a frame (the
homography pose and its planar twin) run as one batch twice the size.

:func:`solve_pnp` launches the pose kernel (``csrc/pnp.cu``: one block a
frame, the same algorithm in float32) for CUDA tensors and runs
:func:`solve_pnp_plain` for CPU tensors; nothing else chooses between
them. Each launch adds one to the counter ``kernels.pnp_launches``
(``profiling``). RANSAC (``pnp/ransac.py``) and the geometry decode
(``ops/geom.py``) call the plain internals (:func:`_dlt_homography`,
:func:`_lm_refine`) on problems of other shapes. With its inputs on the
card neither path synchronises with the host.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from deepcharuco_tpu_torch import _build, profiling
from deepcharuco_tpu_torch.pnp.projection import (
    _dist12,
    _dist_terms,
    matmul_small,
    project_points_jacobian,
    rodrigues,
    rodrigues_inverse,
    undistort_normalize,
)
from deepcharuco_tpu_torch.pnp.smallmath import (
    cholesky_solve,
    inv3,
    polar_rotation,
    smallest_eigvec,
)

_EPS = 1e-12
MAX_POINTS = 4096                 # the kernel's shared memory holds 2 floats a point


def _normalization_transform(pts: torch.Tensor, w: torch.Tensor):
    """Hartley normalization as (scale (..., 1), offset (..., 2)):
    ``pts·scale + offset`` moves the weighted centroid to the origin and the
    mean distance to √2. pts (..., N, 2), w (..., N) weights in {0, 1}."""
    wsum = w.sum(dim=-1, keepdim=True).clamp_min(1.0)
    mean = (pts * w[..., None]).sum(dim=-2) / wsum
    d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(dim=-1) + _EPS)
    mean_d = (d * w).sum(dim=-1, keepdim=True) / wsum
    s = math.sqrt(2.0) / mean_d.clamp_min(_EPS)
    return s, -s * mean


def _similarity(s: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """[[s, 0, ox], [0, s, oy], [0, 0, 1]] from (..., 1) and (..., 2)."""
    o, one = torch.zeros_like(s), torch.ones_like(s)
    return torch.cat([s, o, offset[..., :1], o, s, offset[..., 1:], o, o, one],
                     dim=-1).reshape(*s.shape[:-1], 3, 3)


def _dlt_homography(obj_xy: torch.Tensor, img_xy: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Masked, normalized DLT: H (..., 3, 3) mapping object-plane coords to
    image coords, scaled to H[2, 2] = 1. obj_xy (N, 2) or (..., N, 2),
    img_xy (..., N, 2), w (..., N) 0/1 validity; invalid rows contribute zero
    equations. The null vector of the 2N×9 system is the eigenvector of AᵀA
    with the smallest eigenvalue."""
    obj_xy = obj_xy.expand(*img_xy.shape)
    so, oo = _normalization_transform(obj_xy, w)
    si, oi = _normalization_transform(img_xy, w)
    on = obj_xy * so[..., None, :] + oo[..., None, :]
    im = img_xy * si[..., None, :] + oi[..., None, :]

    X, Y = on[..., 0], on[..., 1]
    x, y = im[..., 0], im[..., 1]
    z, o = torch.zeros_like(X), torch.ones_like(X)
    r1 = torch.stack([X, Y, o, z, z, z, -x * X, -x * Y, -x], dim=-1)
    r2 = torch.stack([z, z, z, X, Y, o, -y * X, -y * Y, -y], dim=-1)
    A = torch.cat([r1, r2], dim=-2) * torch.cat([w, w], dim=-1)[..., None]   # (..., 2N, 9)
    AtA = (A[..., :, :, None] * A[..., :, None, :]).sum(dim=-3)
    Hn = smallest_eigvec(AtA).reshape(*w.shape[:-1], 3, 3)
    H = matmul_small(inv3(_similarity(si, oi)), matmul_small(Hn, _similarity(so, oo)))
    h22 = H[..., 2:, 2:]
    return H / torch.where(h22.abs() > _EPS, h22, torch.ones_like(h22))


def _pose_from_homography(H: torch.Tensor):
    """Planar homography (..., 3, 3) in normalized camera coords, H ∝
    [r1 r2 t] → (R (..., 3, 3), t (..., 3)), the board in front of the
    camera (t_z > 0) and R the nearest rotation to [r1 r2 r1×r2]."""
    H = H * torch.where(H[..., 2:, 2:] < 0, -1.0, 1.0)
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    norm = lambda v: torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    lam = 2.0 / (norm(h1) + norm(h2) + _EPS)
    r1, r2, t = h1 * lam, h2 * lam, h3 * lam
    Q = torch.stack([r1, r2, torch.linalg.cross(r1, r2)], dim=-1)
    return polar_rotation(Q), t


def _lm_refine(obj: torch.Tensor, img: torch.Tensor, w: torch.Tensor,
               K: torch.Tensor, dist, rvec0: torch.Tensor, tvec0: torch.Tensor,
               iters: int = 20):
    """Levenberg–Marquardt on the masked pixel reprojection error, a fixed
    number of iterations. obj (N, 3); img (..., N, 2); w (..., N);
    rvec0/tvec0 (..., 3). Returns (rvec, tvec, cost (...,))."""
    dist = _dist_terms(dist, img.device)
    w2 = w[..., None]

    def linearize(p):
        """Masked residual (..., N, 2), its Jacobian (..., N, 2, 6), cost."""
        pix, J = project_points_jacobian(obj, p[..., :3], p[..., 3:], K, dist)
        r = (pix - img) * w2
        return r, J * w2[..., None], (r * r).sum(dim=(-1, -2))

    # One projection per iteration: the trial point's residual and Jacobian
    # come from the same pass, and an accepted step carries both over.
    p = torch.cat([rvec0, tvec0], dim=-1)
    r, J, cost = linearize(p)
    lam = torch.full_like(cost, 1e-3)
    for _ in range(iters):
        Jf = J.flatten(-3, -2)                                    # (..., 2N, 6)
        JtJ = (Jf[..., :, :, None] * Jf[..., :, None, :]).sum(dim=-3)
        g = (Jf * r.flatten(-2)[..., None]).sum(dim=-2)
        damp = lam[..., None] * (torch.diagonal(JtJ, dim1=-2, dim2=-1) + 1e-12)
        delta = cholesky_solve(JtJ + torch.diag_embed(damp), g)
        p_new = p - delta
        r_new, J_new, cost_new = linearize(p_new)
        better = cost_new < cost
        p = torch.where(better[..., None], p_new, p)
        r = torch.where(better[..., None, None], r_new, r)
        J = torch.where(better[..., None, None, None], J_new, J)
        lam = torch.where(better, (lam * 0.3).clamp_min(1e-12),
                          (lam * 4.0).clamp_max(1e8))
        cost = torch.where(better, cost_new, cost)
    return p[..., :3], p[..., 3:], cost


def _twin_pose(R: torch.Tensor, t: torch.Tensor, obj_centroid: torch.Tensor):
    """The second solution of the two-fold planar-pose ambiguity: the
    board's normal reflected across the view ray through its centroid."""
    n = R[..., :, 2]
    c = matmul_small(R, obj_centroid[..., None])[..., 0] + t
    v = c / (torch.linalg.vector_norm(c, dim=-1, keepdim=True) + _EPS)
    n2 = 2.0 * (n * v).sum(dim=-1, keepdim=True) * v - n
    axis = torch.linalg.cross(n, n2)
    s = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    cos_t = (n * n2).sum(dim=-1, keepdim=True).clamp(-1.0, 1.0)
    theta = torch.atan2(s, cos_t)
    R_delta = rodrigues(axis / (s + _EPS) * theta)
    return matmul_small(R_delta, R), t


def _finish(ok, rvec, tvec, cost, n_points):
    """RMS from the cost; non-finite results become ``ok=False``; poses of
    failed frames are zeroed and their RMS set to +inf."""
    rms = torch.sqrt(cost / n_points.clamp_min(1.0))
    ok = ok & torch.isfinite(rms) & torch.isfinite(rvec).all(dim=-1) \
        & torch.isfinite(tvec).all(dim=-1)
    zero = torch.zeros_like(rvec)
    rvec = torch.where(ok[..., None], rvec, zero)
    tvec = torch.where(ok[..., None], tvec, zero)
    rms = torch.where(ok, rms, torch.full_like(rms, float("inf")))
    return ok, rvec, tvec, rms


@torch.no_grad()
def solve_pnp_plain(object_points: torch.Tensor, image_points: torch.Tensor,
                    valid: torch.Tensor, K: torch.Tensor, dist, iters: int = 20):
    """:func:`solve_pnp` in plain PyTorch, on the tensors' own device: the
    pose kernel's algorithm, step for step."""
    object_points = object_points.float()
    K = K.float()
    dist = _dist_terms(dist, image_points.device)
    w = valid.float()
    n_valid = w.sum(dim=-1)
    ok = n_valid >= 4

    # Degeneracy gate: coincident or collinear points admit arbitrarily bad
    # low-residual poses, so the smaller principal standard deviation of the
    # valid points must exceed 1 px.
    v2 = valid[..., None]
    wsum = n_valid.clamp_min(1.0)[..., None]
    zero2 = torch.zeros((), dtype=image_points.dtype, device=image_points.device)
    mean_ip = torch.where(v2, image_points, zero2).sum(dim=-2) / wsum
    cen = torch.where(v2, image_points - mean_ip[..., None, :], zero2)
    cxx, cyy = ((cen * cen).sum(dim=-2) / wsum).unbind(-1)
    cxy = (cen[..., 0] * cen[..., 1]).sum(dim=-1) / wsum[..., 0]
    tr = cxx + cyy
    det = cxx * cyy - cxy * cxy
    min_eig = tr / 2.0 - torch.sqrt((tr * tr / 4.0 - det).clamp_min(0.0))
    ok = ok & (min_eig > 1.0)

    # Invalid slots may hold anything, NaN included: put the principal point
    # there so that every masked sum stays finite.
    safe = torch.stack([K[0, 2], K[1, 2]]).to(image_points.dtype)
    image_points = torch.where(v2, image_points, safe)

    # Init in undistorted normalized coords: the homography is then [r1 r2 t].
    xn = undistort_normalize(image_points, K, dist)
    R0, t0 = _pose_from_homography(_dlt_homography(object_points[:, :2], xn, w))
    centroid = (object_points * w[..., None]).sum(dim=-2) / wsum
    R1, t1 = _twin_pose(R0, t0, centroid)

    # Refine from the homography pose and from its planar twin as one batch
    # of twice the size; keep the lower cost.
    rv, tv, cost = _lm_refine(object_points, image_points.expand(2, *image_points.shape),
                              w.expand(2, *w.shape), K, dist,
                              rodrigues_inverse(torch.stack([R0, R1])),
                              torch.stack([t0, t1]), iters=iters)
    pick_a = cost[0] <= cost[1]
    rvec = torch.where(pick_a[..., None], rv[0], rv[1])
    tvec = torch.where(pick_a[..., None], tv[0], tv[1])
    cost = torch.where(pick_a, cost[0], cost[1])
    return _finish(ok, rvec, tvec, cost, n_valid)


@functools.lru_cache(maxsize=None)
def _fn():
    lib = _build.library("pnp")
    fn = lib.dc_pnp
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return lib, fn


def _solve_pnp_kernel(object_points, image_points, valid, K, dist, iters):
    """One launch of the pose kernel on the current stream; outputs are new
    tensors, shaped as :func:`solve_pnp_plain`'s."""
    dev = image_points.device
    n = image_points.shape[-2] if image_points.dim() >= 2 else -1
    lead = image_points.shape[:-2]
    if (image_points.dtype != torch.float32 or image_points.dim() < 2
            or image_points.shape[-1] != 2 or not image_points.is_contiguous()
            or not 0 <= n <= MAX_POINTS):
        raise ValueError("pnp kernel: image points must be a contiguous float32 (..., N, 2) "
                         f"tensor with N up to {MAX_POINTS}, got {image_points.dtype} "
                         f"{tuple(image_points.shape)} strides {image_points.stride()}")
    if valid.dtype != torch.bool or valid.device != dev or valid.shape != (*lead, n) \
            or not valid.is_contiguous():
        raise ValueError(f"pnp kernel: valid must be a contiguous bool {(*lead, n)} tensor "
                         f"on {dev}, got {valid.dtype} {tuple(valid.shape)} on {valid.device}")
    object_points, K = object_points.float().contiguous(), K.float().contiguous()
    dist = _dist12(dist, dev).contiguous()
    if object_points.device != dev or object_points.shape != (n, 3):
        raise ValueError(f"pnp kernel: object points must be ({n}, 3) on {dev}, got "
                         f"{tuple(object_points.shape)} on {object_points.device}")
    if K.device != dev or K.shape != (3, 3):
        raise ValueError(f"pnp kernel: K must be (3, 3) on {dev}, got {tuple(K.shape)} "
                         f"on {K.device}")
    if not isinstance(iters, int) or iters < 0:
        raise ValueError(f"pnp kernel: iters must be a whole number >= 0, got {iters!r}")
    m = math.prod(lead)
    ok = torch.empty(lead, dtype=torch.bool, device=dev)
    rvec = torch.empty((*lead, 3), dtype=torch.float32, device=dev)
    tvec, rms = torch.empty_like(rvec), torch.empty(lead, dtype=torch.float32, device=dev)
    if m == 0:
        return ok, rvec, tvec, rms
    lib, fn = _fn()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    args = (image_points.data_ptr(), valid.data_ptr(), object_points.data_ptr(), K.data_ptr(),
            dist.data_ptr(), m, n, iters, ok.data_ptr(), rvec.data_ptr(), tvec.data_ptr(),
            rms.data_ptr(), torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        status = fn(*args)
    if status != 0:
        raise RuntimeError(f"pnp kernel: {_build.error_string(lib, status)}")
    profiling.count("kernels.pnp_launches")
    return ok, rvec, tvec, rms


def solve_pnp(object_points: torch.Tensor, image_points: torch.Tensor,
              valid: torch.Tensor, K: torch.Tensor, dist, iters: int = 20):
    """Planar PnP at fixed capacity, for one frame or any batch of frames:
    one launch of the pose kernel on the current stream (CUDA tensors), or
    :func:`solve_pnp_plain` (CPU tensors).

    Parameters
    ----------
    object_points : (N, 3) board points (z=0 plane), slot k = corner id k.
    image_points : (..., N, 2) detected pixels (same slots).
    valid : (..., N) bool slot occupancy.
    K : (3, 3) camera matrix;  dist : 4/5/8/12 cv2 coefficients.

    On the card the image points are contiguous float32, ``valid``
    contiguous bool, N at most :data:`MAX_POINTS` and every tensor on the
    image points' card; a ``ValueError`` names what the kernel does not
    take.

    Returns
    -------
    ok : (...,) bool — at least 4 valid points that span two dimensions,
        and a finite result.
    rvec, tvec : (..., 3) each — cv2 conventions; zeros when not ok.
    reproj_rms : (...,) float — RMS masked reprojection error in pixels,
        +inf when not ok.
    """
    if not image_points.is_cuda:
        return solve_pnp_plain(object_points, image_points, valid, K, dist, iters=iters)
    return _solve_pnp_kernel(object_points, image_points, valid, K, dist, iters)


def solve_pnp_batch(object_points, image_points, valid, K, dist, iters: int = 20):
    """:func:`solve_pnp` over a leading frame dimension of image points and
    validity (object points, K, dist shared): the same function, which is
    batch-first."""
    return solve_pnp(object_points, image_points, valid, K, dist, iters=iters)

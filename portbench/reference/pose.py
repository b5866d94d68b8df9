"""Planar PnP in plain PyTorch, in any floating dtype (float64 for the
reference): the board's pose from its corners by a normalized DLT
homography (an eigen-decomposition), the pose and its planar twin from it,
then Levenberg–Marquardt on the pixel reprojection error from both starts
with the Jacobian from ``torch.func.jacfwd``, keeping the lower cost.
OpenCV's conventions: rvec axis-angle, distortion ``[k1, k2, p1, p2, k3]``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TINY = 1e-30


def object_points(board: dict) -> np.ndarray:
    """(n_ids, 3) float64: corner id k of a rows x cols board lies at
    ((1 + k % (cols-1)), (1 + k // (cols-1))) squares in the z = 0 plane."""
    rows, cols, sq = board["row_count"], board["col_count"], board["square_len"]
    k = np.arange((rows - 1) * (cols - 1))
    return np.stack([(1 + k % (cols - 1)) * sq, (1 + k // (cols - 1)) * sq,
                     np.zeros(k.shape)], axis=-1).astype(np.float64)


def rodrigues(r: torch.Tensor) -> torch.Tensor:
    """(..., 3) → (..., 3, 3)."""
    t2 = (r * r).sum(-1)
    small = t2 < 1e-10
    t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    a = torch.where(small, 1 - t2 / 6, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24, (1 - torch.cos(t)) / (t * t))
    x, y, z = r.unbind(-1)
    o = torch.zeros_like(x)
    S = torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(*r.shape[:-1], 3, 3)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return eye + a[..., None, None] * S + b[..., None, None] * (S @ S)


def rvec_of(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) → axis-angle (..., 3), through the unit
    quaternion (Shepperd's choice of the largest pivot)."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cands = torch.stack([
        torch.stack([1 + tr, m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1]], -1),
        torch.stack([m[..., 2, 1] - m[..., 1, 2], 1 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                     m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0]], -1),
        torch.stack([m[..., 0, 2] - m[..., 2, 0], m[..., 0, 1] + m[..., 1, 0],
                     1 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2], m[..., 1, 2] + m[..., 2, 1]], -1),
        torch.stack([m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1], 1 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]], -1),
    ], -2)                                                      # (..., 4, 4)
    pivots = torch.stack([1 + tr, 1 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                          1 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
                          1 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]], -1)
    i = pivots.argmax(-1)
    q = torch.gather(cands, -2, i[..., None, None].expand(*i.shape, 1, 4))[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    v = q[..., 1:]
    s = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    ang = 2 * torch.atan2(s, q[..., :1])
    return torch.where(s > 1e-12, v / s.clamp_min(1e-300) * ang, 2 * v)


def distort(xn: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    k1, k2, p1, p2, k3 = d.unbind(-1)
    x, y = xn.unbind(-1)
    r2 = x * x + y * y
    rad = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    return torch.stack([x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
                        y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y], -1)


def project(obj: torch.Tensor, p: torch.Tensor, K: torch.Tensor, d: torch.Tensor):
    """obj (N, 3), pose p (6,) = (rvec, tvec) → pixels (N, 2)."""
    cam = obj @ rodrigues(p[:3]).T + p[3:]
    xd = distort(cam[:, :2] / cam[:, 2:], d)
    return xd * torch.stack([K[0, 0], K[1, 1]]) + torch.stack([K[0, 2], K[1, 2]])


def undistort(pts: torch.Tensor, K: torch.Tensor, d: torch.Tensor, iters: int = 10):
    f = torch.stack([K[0, 0], K[1, 1]])
    c = torch.stack([K[0, 2], K[1, 2]])
    xd = (pts - c) / f
    x = xd
    for _ in range(iters):
        x = xd - (distort(x, d) - x)
    return x


def _hartley(p: torch.Tensor, w: torch.Tensor):
    """(T (..., 3, 3), p mapped): weighted centroid to 0, mean distance √2."""
    ws = w.sum(-1, keepdim=True).clamp_min(1)
    mean = (p * w[..., None]).sum(-2) / ws
    dist = torch.linalg.vector_norm(p - mean[..., None, :], dim=-1)
    s = math.sqrt(2) / ((dist * w).sum(-1, keepdim=True) / ws).clamp_min(1e-12)
    T = torch.zeros(*p.shape[:-2], 3, 3, dtype=p.dtype, device=p.device)
    T[..., 0, 0] = T[..., 1, 1] = s[..., 0]
    T[..., :2, 2] = -s * mean
    T[..., 2, 2] = 1
    return T, (p - mean[..., None, :]) * s[..., None]


def homography(obj_xy: torch.Tensor, xn: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Masked normalized DLT, board plane → normalized image, (F, 3, 3)."""
    To, on = _hartley(obj_xy.expand_as(xn), w)
    Ti, im = _hartley(xn, w)
    X, Y = on.unbind(-1)
    x, y = im.unbind(-1)
    z, o = torch.zeros_like(X), torch.ones_like(X)
    A = torch.cat([torch.stack([X, Y, o, z, z, z, -x * X, -x * Y, -x], -1),
                   torch.stack([z, z, z, X, Y, o, -y * X, -y * Y, -y], -1)], -2)
    A = A * torch.cat([w, w], -1)[..., None]
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    Hn = vecs[..., :, 0].reshape(*w.shape[:-1], 3, 3)
    return torch.linalg.inv(Ti) @ Hn @ To


def pose_from_h(H: torch.Tensor):
    """H ∝ [r1 r2 t] → (R, t), the board in front of the camera, R the
    nearest rotation (SVD) to [r1 r2 r1×r2]."""
    H = H * torch.where(H[..., 2:, 2:] < 0, -1.0, 1.0)
    lam = 2 / (torch.linalg.vector_norm(H[..., :, 0], dim=-1)
               + torch.linalg.vector_norm(H[..., :, 1], dim=-1))
    r1, r2, t = (H[..., :, i] * lam[..., None] for i in range(3))
    U, _, Vh = torch.linalg.svd(torch.stack([r1, r2, torch.linalg.cross(r1, r2)], -1))
    D = torch.ones(*H.shape[:-2], 3, dtype=H.dtype, device=H.device)
    D[..., 2] = torch.sign(torch.linalg.det(U @ Vh))
    return U @ torch.diag_embed(D) @ Vh, t


def twin(R: torch.Tensor, t: torch.Tensor, centroid: torch.Tensor):
    """The planar twin: the board normal reflected across the view ray
    through the board's centroid."""
    n = R[..., :, 2]
    c = (R @ centroid[..., None])[..., 0] + t
    v = c / torch.linalg.vector_norm(c, dim=-1, keepdim=True)
    n2 = 2 * (n * v).sum(-1, keepdim=True) * v - n
    axis = torch.linalg.cross(n, n2)
    s = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    ang = torch.atan2(s, (n * n2).sum(-1, keepdim=True).clamp(-1, 1))
    return rodrigues(axis / s.clamp_min(1e-300) * ang) @ R, t


def solve_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Gaussian elimination without pivoting, for damped normal equations
    (symmetric positive definite), in plain operations of any dtype."""
    n = A.shape[-1]
    M = torch.cat([A, b[..., None]], -1).clone()
    for j in range(n):
        M[..., j, :] = M[..., j, :] / M[..., j, j, None]
        for i in range(n):
            if i != j:
                M[..., i, :] = M[..., i, :] - M[..., i, j, None] * M[..., j, :]
    return M[..., n]


def lm(obj, img, w, K, d, p0, iters: int):
    """Levenberg–Marquardt from p0 (F, 6); img (F, N, 2), w (F, N)."""
    def residual(p, im, wt):
        return ((project(obj, p, K, d) - im) * wt[:, None]).reshape(-1)

    jac = torch.func.vmap(torch.func.jacfwd(residual))
    res = torch.func.vmap(residual)
    p = p0
    r = res(p, img, w)
    cost = (r * r).sum(-1)
    lam = torch.full_like(cost, 1e-3)
    for _ in range(iters):
        J = jac(p, img, w)
        JtJ = J.transpose(-1, -2) @ J
        g = (J.transpose(-1, -2) @ r[..., None])[..., 0]
        diag = torch.diagonal(JtJ, dim1=-2, dim2=-1)
        delta = solve_small(JtJ + torch.diag_embed(lam[..., None] * (diag + 1e-12)), g)
        p_new = p - delta
        r_new = res(p_new, img, w)
        c_new = (r_new * r_new).sum(-1)
        better = c_new < cost
        p = torch.where(better[:, None], p_new, p)
        r = torch.where(better[:, None], r_new, r)
        cost = torch.where(better, c_new, cost)
        lam = torch.where(better, (lam * 0.3).clamp_min(1e-12), (lam * 4).clamp_max(1e8))
    return p, cost


def gate(img: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """At least 4 valid points whose smaller principal variance exceeds
    1 px² (coincident or collinear corners fix no pose)."""
    w = valid.to(img.dtype)
    n = w.sum(-1)
    mean = (img * w[..., None]).sum(-2) / n.clamp_min(1)[..., None]
    c = (img - mean[..., None, :]) * w[..., None]
    cxx = (c[..., 0] ** 2).sum(-1) / n.clamp_min(1)
    cyy = (c[..., 1] ** 2).sum(-1) / n.clamp_min(1)
    cxy = (c[..., 0] * c[..., 1]).sum(-1) / n.clamp_min(1)
    tr, det = cxx + cyy, cxx * cyy - cxy * cxy
    min_eig = tr / 2 - torch.sqrt((tr * tr / 4 - det).clamp_min(0))
    return (n >= 4) & (min_eig > 1)


def solve(board: dict, K, dist, corners, valid, dtype=torch.float64, iters: int = 50,
          twin_out: bool = False):
    """Poses of frames: corners (F, n_ids, 2), valid (F, n_ids) → (ok (F,),
    rvec (F, 3), tvec (F, 3), reprojection RMS (F,)) as float64 numpy.
    The start (homography, twin) is reckoned in float64 and then rounded to
    ``dtype``, in which Levenberg–Marquardt runs. With ``twin_out`` also
    the other start's end: its RMS (F,) and its rotation's angle from the
    chosen pose's (F,), radians."""
    dev = corners.device if torch.is_tensor(corners) else "cpu"
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    img = torch.as_tensor(corners, device=dev).double()
    valid = torch.as_tensor(valid, device=dev).bool()
    obj, K, d = f64(object_points(board)), f64(K), f64(np.asarray(dist)[:5])
    ok = gate(img, valid)
    safe = torch.where(valid[..., None], img, K[:2, 2])
    w = valid.double()
    R0, t0 = pose_from_h(homography(obj[:, :2], undistort(safe, K, d), w))
    cen = (obj * w[..., None]).sum(-2) / w.sum(-1, keepdim=True).clamp_min(1)
    R1, t1 = twin(R0, t0, cen)
    p0 = torch.cat([torch.cat([rvec_of(R0), t0], -1), torch.cat([rvec_of(R1), t1], -1)])
    c = lambda a: a.to(dtype)
    p, cost = lm(c(obj), c(safe).repeat(2, 1, 1), c(w).repeat(2, 1), c(K), c(d), c(p0),
                 iters)
    p, cost = p.double(), cost.double()
    nf = img.shape[0]
    pick = cost[:nf] <= cost[nf:]
    other = torch.where(pick[:, None], p[nf:], p[:nf])
    other_cost = torch.where(pick, cost[nf:], cost[:nf])
    p = torch.where(pick[:, None], p[:nf], p[nf:])
    cost = torch.where(pick, cost[:nf], cost[nf:])
    rms = torch.sqrt(cost / w.sum(-1).clamp_min(1))
    ok = ok & torch.isfinite(rms) & torch.isfinite(p).all(-1)
    n = lambda t: t.detach().cpu().numpy()
    if not twin_out:
        return n(ok), n(p[:, :3]), n(p[:, 3:]), n(rms)
    rel = rodrigues(other[:, :3]) @ rodrigues(p[:, :3]).transpose(-1, -2)
    cos = ((rel[:, 0, 0] + rel[:, 1, 1] + rel[:, 2, 2] - 1) / 2).clamp(-1, 1)
    return (n(ok), n(p[:, :3]), n(p[:, 3:]), n(rms),
            n(torch.sqrt(other_cost / w.sum(-1).clamp_min(1))), n(torch.arccos(cos)))


def rms_at(board: dict, K, dist, corners, valid, rvec, tvec) -> np.ndarray:
    """Reprojection RMS (F,) of the given poses on the given corners,
    float64."""
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    obj, K, d = f64(object_points(board)), f64(K), f64(np.asarray(dist)[:5])
    p = torch.cat([f64(rvec), f64(tvec)], -1)
    w = f64(valid)
    pix = torch.stack([project(obj, pi, K, d) for pi in p])
    err = ((pix - f64(corners)) ** 2).sum(-1) * w
    return torch.sqrt(err.sum(-1) / w.sum(-1).clamp_min(1)).numpy()

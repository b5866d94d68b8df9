"""Camera model: Rodrigues rotations, Brown–Conrady distortion, projection.

OpenCV conventions throughout (rvec axis-angle, distortion coefficient order
``[k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4]``), the same arithmetic
as ``deepcharuco_tpu.pnp.projection``. Batch-first: ``rvec``/``tvec`` are
(..., 3), rotations (..., 3, 3), point sets (..., N, 2|3); ``K`` (3, 3) and
``dist`` are one camera's. Float32, no host synchronisation, no product
that a TF32 setting could touch (the 3×3 products are written out as sums).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

_EPS = 1e-12


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) → the cross-product matrix (..., 3, 3): ``skew(v) @ x = v × x``."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(*v.shape[:-1], 3, 3)


def matmul_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for small trailing matrices as a broadcast multiply and a
    sum in float32: exact f32 products on any device and setting."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _rodrigues_coeffs(theta2: torch.Tensor, derivatives: bool = False):
    """a = sin θ/θ and b = (1 − cos θ)/θ², with the small-angle series near
    0; with ``derivatives`` also a'(θ)/θ and b'(θ)/θ, which turn ∂/∂θ into
    ∂/∂r (∂θ/∂r = r/θ)."""
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-10
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, sin_t / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos_t) / (theta2 + _EPS))
    if not derivatives:
        return a, b
    theta3 = theta * theta * theta
    da = torch.where(small, -1.0 / 3.0, (theta * cos_t - sin_t) / theta3)
    db = torch.where(small, -1.0 / 12.0,
                     (theta * sin_t - 2.0 * (1.0 - cos_t)) / (theta3 * theta))
    return a, b, da, db


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) → rotation matrix (..., 3, 3), Taylor-safe at θ→0."""
    a, b = _rodrigues_coeffs((rvec * rvec).sum(dim=-1))
    Kx = skew(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + a[..., None, None] * Kx + b[..., None, None] * matmul_small(Kx, Kx)


def rodrigues_inverse(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) → axis-angle (..., 3) (principal branch,
    θ ∈ [0, π])."""
    diag = torch.diagonal(R, dim1=-2, dim2=-1)
    cos_t = ((diag.sum(dim=-1) - 1.0) * 0.5).clamp(-1.0, 1.0)
    theta = torch.acos(cos_t)
    # generic case: axis from the skew-symmetric part
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    generic = w * (theta / (2.0 * torch.sin(theta) + _EPS))[..., None]
    near_zero = (theta < 1e-6)[..., None]
    near_pi = (math.pi - theta < 1e-4)[..., None]
    # θ≈π: axis from the diagonal of (R + I)/2 = aaᵀ, signs from off-diagonals
    aa = torch.sqrt((diag * 0.5 + 0.5).clamp_min(0.0))
    sx = torch.where(R[..., 0, 1] + R[..., 1, 0] >= 0, 1.0, -1.0)
    sz = torch.where(R[..., 1, 2] + R[..., 2, 1] >= 0, 1.0, -1.0)
    axis_pi = aa * torch.stack([sx, torch.ones_like(sx), sz], dim=-1)
    axis_pi = axis_pi / (torch.linalg.vector_norm(axis_pi, dim=-1, keepdim=True) + _EPS)
    out = torch.where(near_pi, axis_pi * theta[..., None], generic)
    return torch.where(near_zero, w * 0.5, out)


def _dist12(dist, device=None) -> torch.Tensor:
    """A 4/5/8/12-coefficient cv2 distortion vector, zero-padded to 12
    float32 values. The 14-element tilted-sensor model is refused."""
    d = torch.as_tensor(dist, dtype=torch.float32, device=device).reshape(-1)
    n = d.shape[0]
    if n > 12:
        raise ValueError(
            f"{n}-coefficient distortion (tilted-sensor model) unsupported")
    return F.pad(d, (0, 12 - n)) if n < 12 else d


class _Dist(NamedTuple):
    """A distortion vector as the coefficient pairs of the vector form, the
    x and the y component side by side, each (2,)."""

    c0: torch.Tensor    # [k1, k4]: radial numerator and denominator, r² term
    c1: torch.Tensor    # [k2, k5]: r⁴ term
    c2: torch.Tensor    # [k3, k6]: r⁶ term
    p: torch.Tensor     # [p1, p2]
    pf: torch.Tensor    # [p2, p1]
    s1: torch.Tensor    # [s1, s3]
    s2: torch.Tensor    # [s2, s4]


def _dist_terms(dist, device=None) -> _Dist:
    """:class:`_Dist` of a cv2 distortion vector (or ``dist`` itself when it
    is one already: a solver's loop splits the vector once)."""
    if isinstance(dist, _Dist):
        return dist
    d = _dist12(dist, device)
    pair = lambda i, j: torch.stack([d[i], d[j]])
    return _Dist(pair(0, 5), pair(1, 6), pair(4, 7), d[2:4], d[2:4].flip(0),
                 pair(8, 10), pair(9, 11))


def _distort(xn: torch.Tensor, dist, jacobian: bool = False):
    """:func:`distort` in vector form and, with ``jacobian``, also
    ∂ distort(xn) / ∂ xn, (..., 2, 2)."""
    D = _dist_terms(dist, xn.device)
    vv = xn * xn
    r2 = vv.sum(dim=-1, keepdim=True)                           # (..., 1)
    nd = 1.0 + r2 * (D.c0 + r2 * (D.c1 + r2 * D.c2))            # numerator, denominator
    radial = nd[..., :1] / nd[..., 1:]
    xy = xn[..., :1] * xn[..., 1:]
    prism = D.s1 + D.s2 * r2
    xd = xn * radial + 2.0 * xy * D.p + D.pf * (r2 + 2.0 * vv) + r2 * prism
    if not jacobian:
        return xd
    dnd = D.c0 + r2 * (2.0 * D.c1 + 3.0 * D.c2 * r2)            # ∂(num, den)/∂r²
    drad = (dnd[..., :1] - radial * dnd[..., 1:]) / nd[..., 1:]
    # every term but two is (something)_i · 2 xn_k, an outer product with xn;
    # ∂(r² prism)/∂r² = s1 + 2 s2 r² = prism + s2 r²
    u = 2.0 * (drad * xn + D.pf + prism + D.s2 * r2)
    J = (u[..., :, None] * xn[..., None, :]
         + 2.0 * D.p[:, None] * xn.flip(-1)[..., None, :]       # ∂(2 x y p_i)
         + torch.diag_embed(radial + 4.0 * D.pf * xn))          # radial·I, ∂(2 pf_i xn_i²)
    return xd, J


def distort(xn: torch.Tensor, dist) -> torch.Tensor:
    """cv2's rational + thin-prism distortion of ideal normalized coords
    (..., 2); with only the first 5 coefficients non-zero this is the plain
    Brown–Conrady model:

        x_d = x·radial + 2 p1 x y + p2 (r² + 2 x²) + r² (s1 + s2 r²)
        y_d = y·radial + p1 (r² + 2 y²) + 2 p2 x y + r² (s3 + s4 r²)
        radial = (1 + k1 r² + k2 r⁴ + k3 r⁶) / (1 + k4 r² + k5 r⁴ + k6 r⁶)
    """
    return _distort(xn, dist)


def undistort_normalize(pts: torch.Tensor, K: torch.Tensor, dist,
                        iters: int = 8) -> torch.Tensor:
    """Pixel coords (..., 2) → ideal normalized coords, inverting the
    distortion by a fixed number of fixed-point steps."""
    f = torch.stack([K[0, 0], K[1, 1]])
    c = torch.stack([K[0, 2], K[1, 2]])
    d = _dist_terms(dist, pts.device)
    xd = (pts - c) / f
    x = xd
    for _ in range(iters):
        x = xd - (distort(x, d) - x)
    return x


def project_points(obj: torch.Tensor, rvec: torch.Tensor, tvec: torch.Tensor,
                   K: torch.Tensor, dist) -> torch.Tensor:
    """cv2.projectPoints semantics: object points (N, 3) (or (..., N, 3))
    under poses (..., 3) → pixels (..., N, 2)."""
    R = rodrigues(rvec)
    cam = matmul_small(obj, R.transpose(-1, -2)) + tvec[..., None, :]
    xn = cam[..., :2] / cam[..., 2:3].clamp_min(_EPS)
    xd = distort(xn, dist)
    f = torch.stack([K[0, 0], K[1, 1]])
    c = torch.stack([K[0, 2], K[1, 2]])
    return xd * f + c


def project_points_jacobian(obj: torch.Tensor, rvec: torch.Tensor,
                            tvec: torch.Tensor, K: torch.Tensor, dist):
    """:func:`project_points` and its derivative with respect to the pose:
    pixels (..., N, 2) and ∂pixels/∂(rvec, tvec) (..., N, 2, 6), analytic
    (what forward-mode differentiation of the projection gives)."""
    a, b, da, db = _rodrigues_coeffs((rvec * rvec).sum(dim=-1), derivatives=True)
    Kx = skew(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    R = eye + a[..., None, None] * Kx + b[..., None, None] * matmul_small(Kx, Kx)
    cam = matmul_small(obj, R.transpose(-1, -2)) + tvec[..., None, :]
    # ∂(R X)/∂r, (..., N, 3, 3), from R X = X + a·r×X + b·r×(r×X)
    Kx = Kx[..., None, :, :]                              # (..., 1, 3, 3)
    KX = matmul_small(Kx, obj[..., None])                 # (..., N, 3, 1) r × X
    KKX = matmul_small(Kx, KX)
    SX = skew(obj)                                        # (N, 3, 3)
    per_point = lambda t: t[..., None, None, None]
    r_row = rvec[..., None, None, :]                      # (..., 1, 1, 3)
    dcam_dr = (-(per_point(a) * SX)
               - per_point(b) * (skew(KX[..., 0]) + matmul_small(Kx, SX))
               + KX * (per_point(da) * r_row)
               + KKX * (per_point(db) * r_row))
    z = cam[..., 2:]                                      # (..., N, 1)
    zc = z.clamp_min(_EPS)
    xn = cam[..., :2] / zc
    inv_z = 1.0 / zc
    # ∂xn/∂cam = [I/z | −xn/z], (..., N, 2, 3); the clamp passes no
    # derivative below it
    dz = torch.where(z > _EPS, -inv_z, 0.0)
    dxn = torch.cat([torch.diag_embed(inv_z.expand(*xn.shape)), (xn * dz)[..., None]],
                    dim=-1)
    f = torch.stack([K[0, 0], K[1, 1]])
    c = torch.stack([K[0, 2], K[1, 2]])
    xd, dxd = _distort(xn, dist, jacobian=True)
    dpix_dcam = matmul_small(dxd * f[:, None], dxn)
    J = torch.cat([matmul_small(dpix_dcam, dcam_dr), dpix_dcam], dim=-1)
    return xd * f + c, J

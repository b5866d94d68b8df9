"""Camera calibration in numpy float64: what ``cli.calib_intrinsics`` takes
from cv2 (``deepcharuco_tpu/cli/calib_intrinsics.py``), restated for the
card's machine, which has no cv2.

- :func:`rodrigues` and :func:`project_points`: ``cv2.Rodrigues`` and
  ``cv2.projectPoints`` with the 5-coefficient Brown–Conrady model
  ``(k1, k2, p1, p2, k3)``.
- :func:`calibrate_camera`: ``cv2.calibrateCamera`` for planar targets
  (object points with z = 0), in its three stages: the intrinsics from the
  views' homographies (``initIntrinsicParams2D``), each view's pose from its
  homography refined by Levenberg–Marquardt, then one Levenberg–Marquardt
  over the intrinsics, the distortion and every pose, with OpenCV's step
  (normal equations with the diagonal scaled by 1 + λ, λ from 1e-3 and
  moved by decades) and cv2 5.0.0's default termination (500 trials or a
  relative step under ``DBL_EPSILON``). Flags: 0 and
  ``CALIB_ZERO_TANGENT_DIST | CALIB_FIX_K3``. Where the views determine the
  camera the result is cv2's to about 1e-9; where they do not (a few
  frontal views under the full distortion model) the solver drifts along
  a valley and the result depends on every rounding, cv2's too (see
  ``PERF.md`` §6).
- :func:`find_chessboard_corners`: the counterpart of
  ``cv2.findChessboardCorners(gray, (cols, rows), ADAPTIVE_THRESH |
  FAST_CHECK | NORMALIZE_IMAGE)``. It does not copy OpenCV's quad linking:
  the dark squares are found as connected components of thresholded,
  eroded masks, their touching corners paired into inner corners and the
  corners joined into a grid along the squares' sides. The grid is ordered
  as OpenCV orders it (rows of ``cols`` corners, the turn from one row to
  the next clockwise on the image), up to a turn by 180°.

Sub-pixel refinement of many points at once is
:func:`deepcharuco_tpu_torch.data.cvnp.corner_sub_pix`.

``tests/test_torch_calib.py`` holds each function to cv2 5.0.0.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from deepcharuco_tpu_torch.data import cvnp

CALIB_ZERO_TANGENT_DIST = 8      # cv2's flag values
CALIB_FIX_K3 = 128
DBL_EPSILON = float(np.finfo(np.float64).eps)
FLT_EPSILON = float(np.finfo(np.float32).eps)
# cv2 5.0.0's default termination of calibrateCamera's last stage, as the JAX
# CLI calls it (no criteria): its result equals the one with an explicit
# count of 500 trials and differs from 499 on an ill-posed set.
_CALIB_TRIALS = 500
_HOMOGRAPHY_STEPS = 10


# ---------------------------------------------------------------------------
# Rotations and projection
# ---------------------------------------------------------------------------

def _skew(v: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])


def rodrigues(x) -> np.ndarray:
    """``cv2.Rodrigues``: a rotation vector (3,) → its matrix (3, 3), or a
    matrix → its vector (3,), as OpenCV computes each (the matrix is first
    made orthonormal through its SVD)."""
    x = np.asarray(x, np.float64)
    if x.size == 3:
        r = x.reshape(3)
        theta = float(np.sqrt(r @ r))
        if theta < DBL_EPSILON:
            return np.eye(3)
        c, s = np.cos(theta), np.sin(theta)
        u = r / theta
        return c * np.eye(3) + (1.0 - c) * np.outer(u, u) + s * _skew(u)
    U, _, Vt = np.linalg.svd(x.reshape(3, 3))
    R = U @ Vt
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = np.sqrt((r @ r) * 0.25)
    c = min(max((R[0, 0] + R[1, 1] + R[2, 2] - 1.0) * 0.5, -1.0), 1.0)
    theta = np.arccos(c)
    if s >= 1e-5:
        return r * (theta / (2.0 * s))
    if c > 0:
        return np.zeros(3)
    r = np.sqrt(np.maximum((np.diag(R) + 1.0) * 0.5, 0.0))
    r[1] *= -1.0 if R[0, 1] < 0 else 1.0
    r[2] *= -1.0 if R[0, 2] < 0 else 1.0
    if abs(r[0]) < abs(r[1]) and abs(r[0]) < abs(r[2]) and (R[1, 2] > 0) != (r[1] * r[2] > 0):
        r[2] = -r[2]
    return r * (theta / np.sqrt(r @ r))


def _rodrigues_jac(r: np.ndarray, R: np.ndarray) -> np.ndarray:
    """(3, 3, 3): ∂R/∂r_i for i = 0..2 (Gallego and Yezzi's closed form;
    the generators of rotation at r = 0)."""
    th2 = float(r @ r)
    if th2 < DBL_EPSILON ** 2:
        return np.stack([_skew(e) for e in np.eye(3)])
    IR = np.eye(3) - R
    return np.stack([(r[i] * _skew(r) + _skew(np.cross(r, IR[:, i]))) / th2 @ R
                     for i in range(3)])


def _dist5(dist) -> np.ndarray:
    d = np.zeros(5)
    if dist is not None:
        flat = np.asarray(dist, np.float64).ravel()
        d[:min(5, flat.size)] = flat[:5]
    return d


def _project(obj: np.ndarray, rvec, tvec, intr: np.ndarray, jacobian: bool = False):
    """Pinhole + Brown–Conrady projection of (N, 3) points. ``intr`` is
    (fx, fy, cx, cy, k1, k2, p1, p2, k3). → (N, 2), and with ``jacobian``
    ∂/∂intr (N, 2, 9) and ∂/∂(rvec, tvec) (N, 2, 6)."""
    fx, fy, cx, cy, k1, k2, p1, p2, k3 = intr
    r = np.asarray(rvec, np.float64).reshape(3)
    R = rodrigues(r)
    X = obj @ R.T + np.asarray(tvec, np.float64).reshape(3)
    z = X[:, 2]
    iz = np.where(z != 0, 1.0 / np.where(z != 0, z, 1.0), 1.0)
    x, y = X[:, 0] * iz, X[:, 1] * iz
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    a1, a2, a3 = 2.0 * x * y, r2 + 2.0 * x * x, r2 + 2.0 * y * y
    xd = x * radial + p1 * a1 + p2 * a2
    yd = y * radial + p1 * a3 + p2 * a1
    uv = np.stack([fx * xd + cx, fy * yd + cy], axis=1)
    if not jacobian:
        return uv
    n = len(obj)
    Ji = np.zeros((n, 2, 9))
    Ji[:, 0, 0], Ji[:, 1, 1] = xd, yd
    Ji[:, 0, 2] = Ji[:, 1, 3] = 1.0
    for col, (gx, gy) in zip((4, 5, 8, 6, 7), ((x * r2, y * r2), (x * r2 ** 2, y * r2 ** 2),
                                              (x * r2 ** 3, y * r2 ** 3), (a1, a3), (a2, a1))):
        Ji[:, 0, col], Ji[:, 1, col] = fx * gx, fy * gy
    drad = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)        # ∂radial/∂r2
    dxd_dx = radial + 2.0 * x * x * drad + 2.0 * p1 * y + 6.0 * p2 * x
    dxd_dy = 2.0 * x * y * drad + 2.0 * p1 * x + 2.0 * p2 * y
    dyd_dx = 2.0 * x * y * drad + 2.0 * p1 * x + 2.0 * p2 * y
    dyd_dy = radial + 2.0 * y * y * drad + 6.0 * p1 * y + 2.0 * p2 * x
    duv_dxy = np.stack([np.stack([fx * dxd_dx, fx * dxd_dy], -1),
                        np.stack([fy * dyd_dx, fy * dyd_dy], -1)], 1)       # (N, 2, 2)
    dxy_dX = np.zeros((n, 2, 3))
    dxy_dX[:, 0, 0] = dxy_dX[:, 1, 1] = iz
    dxy_dX[:, 0, 2], dxy_dX[:, 1, 2] = -x * iz, -y * iz
    duv_dX = np.einsum("nij,njk->nik", duv_dxy, dxy_dX)                    # (N, 2, 3)
    dX_dr = np.einsum("iab,nb->nai", _rodrigues_jac(r, R), obj)            # (N, 3, 3)
    Je = np.concatenate([np.einsum("nij,njk->nik", duv_dX, dX_dr), duv_dX], axis=2)
    return uv, Ji, Je


def project_points(object_points, rvec, tvec, camera_matrix, dist=None) -> np.ndarray:
    """``cv2.projectPoints(object_points, rvec, tvec, K, dist)`` with up to
    five distortion coefficients: (N, 2) float64 (cv2 gives (N, 1, 2))."""
    K = np.asarray(camera_matrix, np.float64)
    intr = np.concatenate([[K[0, 0], K[1, 1], K[0, 2], K[1, 2]], _dist5(dist)])
    return _project(np.asarray(object_points, np.float64).reshape(-1, 3), rvec, tvec, intr)


# ---------------------------------------------------------------------------
# Homographies and the initial estimates
# ---------------------------------------------------------------------------

def find_homography(src, dst) -> np.ndarray:
    """The least-squares homography of ``cv2.findHomography(src, dst, 0)``:
    the DLT on points normalised per axis (centroid, mean absolute
    deviation), then at most ``_HOMOGRAPHY_STEPS`` Gauss–Newton steps on
    the reprojection error in ``dst`` with H[2, 2] = 1. (3, 3)."""
    src = np.asarray(src, np.float64).reshape(-1, 2)
    dst = np.asarray(dst, np.float64).reshape(-1, 2)

    def norm(p):
        c = p.mean(0)
        s = len(p) / np.maximum(np.abs(p - c).sum(0), DBL_EPSILON)
        return np.array([[s[0], 0, -c[0] * s[0]], [0, s[1], -c[1] * s[1]], [0, 0, 1]])

    Tm, TM = norm(dst), norm(src)
    M = src * np.diag(TM)[:2] + TM[:2, 2]
    m = dst * np.diag(Tm)[:2] + Tm[:2, 2]
    one, zero = np.ones(len(M)), np.zeros(len(M))
    Lx = np.stack([M[:, 0], M[:, 1], one, zero, zero, zero,
                   -m[:, 0] * M[:, 0], -m[:, 0] * M[:, 1], -m[:, 0]], 1)
    Ly = np.stack([zero, zero, zero, M[:, 0], M[:, 1], one,
                   -m[:, 1] * M[:, 0], -m[:, 1] * M[:, 1], -m[:, 1]], 1)
    L = np.concatenate([Lx, Ly])
    _, vecs = np.linalg.eigh(L.T @ L)
    H = np.linalg.inv(Tm) @ vecs[:, 0].reshape(3, 3) @ TM
    H = H / H[2, 2]
    h = H.ravel()[:8].copy()
    for _ in range(_HOMOGRAPHY_STEPS):
        Hm = np.append(h, 1.0).reshape(3, 3)
        w = src @ Hm[2, :2] + Hm[2, 2]
        u = (src @ Hm[0, :2] + Hm[0, 2]) / w
        v = (src @ Hm[1, :2] + Hm[1, 2]) / w
        e = np.concatenate([u - dst[:, 0], v - dst[:, 1]])
        J = np.zeros((2 * len(src), 8))
        iw = 1.0 / w
        J[:len(src), 0:3] = np.stack([src[:, 0], src[:, 1], np.ones(len(src))], 1) * iw[:, None]
        J[len(src):, 3:6] = J[:len(src), 0:3]
        J[:len(src), 6:8] = -src * (u * iw)[:, None]
        J[len(src):, 6:8] = -src * (v * iw)[:, None]
        step = np.linalg.lstsq(J, e, rcond=None)[0]
        h = h - step
        if np.linalg.norm(step) <= DBL_EPSILON * max(np.linalg.norm(h), 1.0):
            break
    return np.append(h, 1.0).reshape(3, 3)


def init_intrinsics_2d(object_points: Sequence[np.ndarray], image_points: Sequence[np.ndarray],
                       size_wh: Tuple[int, int]) -> np.ndarray:
    """``cv2.initCameraMatrix2D`` without an aspect ratio, as
    ``calibrateCamera`` starts: principal point at ((w−1)/2, (h−1)/2), fx and
    fy from the vanishing points of each view's homography. (3, 3)."""
    w, h = size_wh
    cx, cy = (w - 1) * 0.5 if w else 0.5, (h - 1) * 0.5 if h else 0.5
    A, b = [], []
    for obj, img in zip(object_points, image_points):
        H = find_homography(np.asarray(obj, np.float64).reshape(-1, 3)[:, :2], img).copy()
        H[0] -= H[2] * cx
        H[1] -= H[2] * cy
        hv, vv = H[:, 0], H[:, 1]
        d1, d2 = (hv + vv) * 0.5, (hv - vv) * 0.5
        hv, vv = hv / np.linalg.norm(hv), vv / np.linalg.norm(vv)
        d1, d2 = d1 / np.linalg.norm(d1), d2 / np.linalg.norm(d2)
        A += [[hv[0] * vv[0], hv[1] * vv[1]], [d1[0] * d2[0], d1[1] * d2[1]]]
        b += [-hv[2] * vv[2], -d1[2] * d2[2]]
    f = np.linalg.lstsq(np.array(A), np.array(b), rcond=None)[0]
    return np.array([[np.sqrt(abs(1.0 / f[0])), 0.0, cx],
                     [0.0, np.sqrt(abs(1.0 / f[1])), cy], [0.0, 0.0, 1.0]])


def _levmarq(param: np.ndarray, free: np.ndarray, normal_eq, max_iter: int, eps: float):
    """OpenCV's Levenberg–Marquardt (the step and λ rule of
    ``CvLevMarq::updateAlt``, the count of cv2 5.0.0): ``normal_eq(p,
    want_jac)`` returns (JᵀJ, Jᵀe, Σe²) at ``p`` (only Σe² without
    ``want_jac``). A trial solves (JᵀJ with its diagonal × (1 + λ)) δ = Jᵀe
    over the free parameters, λ = 10^lg starting at 1e-3; an accepted trial
    moves λ one decade down, a rejected one (Σe² grew) one decade up, to at
    most 1e16. ``max_iter`` counts trials, accepted or not (a run cut by it
    after a rejected trial keeps the last accepted point); a step under
    ``eps`` relative to the parameters ends the run. → (parameters, Σe²)."""
    lg = -3
    JtJ, JtE, err = normal_eq(param, True)
    idx = np.nonzero(free)[0]
    trials = 0
    while True:
        A = JtJ[np.ix_(idx, idx)]
        g = JtE[idx]
        prev = param
        while True:
            An = A.copy()
            An[np.diag_indices_from(An)] *= 1.0 + 10.0 ** lg
            param = prev.copy()
            param[idx] -= np.linalg.lstsq(An, g, rcond=None)[0]
            new_err = normal_eq(param, False)[2]
            trials += 1
            if new_err > err:
                lg += 1
                if lg <= 16:
                    if trials >= max_iter:
                        return prev, err
                    continue
            break
        lg = max(lg - 1, -16)
        err = new_err
        if trials >= max_iter or np.linalg.norm(param - prev) < eps * np.linalg.norm(prev):
            return param, err
        JtJ, JtE, err = normal_eq(param, True)


def _view_pose_normal_eq(obj, img, intr):
    def normal_eq(p, want_jac):
        if not want_jac:
            e = _project(obj, p[:3], p[3:], intr) - img
            return None, None, float((e * e).sum())
        uv, _, Je = _project(obj, p[:3], p[3:], intr, jacobian=True)
        e = (uv - img).reshape(-1)
        J = Je.reshape(-1, 6)
        return J.T @ J, J.T @ e, float(e @ e)
    return normal_eq


def init_extrinsics(obj: np.ndarray, img: np.ndarray, intr: np.ndarray):
    """One planar view's pose as ``cv2.calibrateCamera`` starts it
    (``findExtrinsicCameraParams2``, before any distortion is fitted): the
    homography from the board plane (about its centroid) to the normalised
    points gives R and t, then 20 Levenberg–Marquardt trials under the
    intrinsics ``intr``. → (rvec (3,), tvec (3,))."""
    mn = (img - intr[2:4]) / intr[0:2]
    Mc = obj.mean(0)
    H = find_homography(obj[:, :2] - Mc[:2], mn)
    h1n, h2n = np.linalg.norm(H[:, 0]), np.linalg.norm(H[:, 1])
    h1 = H[:, 0] / max(h1n, DBL_EPSILON)
    h2 = H[:, 1] / max(h2n, DBL_EPSILON)
    t = H[:, 2] * (2.0 / max(h1n + h2n, DBL_EPSILON))
    R = rodrigues(rodrigues(np.column_stack([h1, h2, np.cross(h1, h2)])))
    t = t - R @ Mc                         # the plane's origin back at the object's
    p = np.concatenate([rodrigues(R), t])
    p, _ = _levmarq(p, np.ones(6, bool), _view_pose_normal_eq(obj, img, intr), 20, FLT_EPSILON)
    return p[:3], p[3:]


# ---------------------------------------------------------------------------
# calibrateCamera
# ---------------------------------------------------------------------------

def calibrate_camera(object_points: Sequence[np.ndarray], image_points: Sequence[np.ndarray],
                     size_wh: Tuple[int, int], flags: int = 0):
    """``cv2.calibrateCamera(object_points, image_points, (w, h), None, None,
    flags=flags)`` for planar targets (z = 0). ``flags``: 0 (k1, k2, p1, p2,
    k3 free) or any of ``CALIB_ZERO_TANGENT_DIST`` and ``CALIB_FIX_K3`` (held
    at 0). It ends as cv2's default criteria end it: after
    ``_CALIB_TRIALS`` trials or a relative step under ``DBL_EPSILON``. →
    ``(rms, K (3, 3), dist (1, 5), rvecs, tvecs)`` with each rvec and tvec
    (3, 1), as cv2 returns them."""
    if flags & ~(CALIB_ZERO_TANGENT_DIST | CALIB_FIX_K3):
        raise ValueError(f"unsupported calibration flags {flags:#x}")
    objs = [np.asarray(o, np.float64).reshape(-1, 3) for o in object_points]
    imgs = [np.asarray(i, np.float64).reshape(-1, 2) for i in image_points]
    if len(objs) != len(imgs) or not objs:
        raise ValueError("need one set of image points per set of object points")
    for o, i in zip(objs, imgs):
        if len(o) != len(i) or len(o) < 4:
            raise ValueError("each view needs at least 4 matching points")
        if np.any(np.abs(o[:, 2]) > 1e-5):
            raise ValueError("non-planar object points need an initial camera matrix, "
                             "which this restatement does not take")
    K0 = init_intrinsics_2d(objs, imgs, size_wh)
    intr = np.array([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2], 0, 0, 0, 0, 0], np.float64)
    poses = [np.concatenate(init_extrinsics(o, i, intr)) for o, i in zip(objs, imgs)]
    n = len(objs)
    free = np.ones(9 + 6 * n, bool)
    if flags & CALIB_ZERO_TANGENT_DIST:
        free[6:8] = False
    if flags & CALIB_FIX_K3:
        free[8] = False

    def normal_eq(p, want_jac):
        if not want_jac:
            err = 0.0
            for v in range(n):
                e = _project(objs[v], p[9 + 6 * v:12 + 6 * v], p[12 + 6 * v:15 + 6 * v],
                             p[:9]) - imgs[v]
                err += float((e * e).sum())
            return None, None, err
        JtJ = np.zeros((len(p), len(p)))
        JtE = np.zeros(len(p))
        err = 0.0
        for v in range(n):
            s = slice(9 + 6 * v, 15 + 6 * v)
            uv, Ji, Je = _project(objs[v], p[s][:3], p[s][3:], p[:9], jacobian=True)
            e = (uv - imgs[v]).reshape(-1)
            Ji, Je = Ji.reshape(-1, 9), Je.reshape(-1, 6)
            JtJ[:9, :9] += Ji.T @ Ji
            JtJ[:9, s] = Ji.T @ Je
            JtJ[s, :9] = JtJ[:9, s].T
            JtJ[s, s] = Je.T @ Je
            JtE[:9] += Ji.T @ e
            JtE[s] = Je.T @ e
            err += float(e @ e)
        return JtJ, JtE, err

    p = np.concatenate([intr] + poses)
    p, err = _levmarq(p, free, normal_eq, _CALIB_TRIALS, DBL_EPSILON)
    K = np.array([[p[0], 0.0, p[2]], [0.0, p[1], p[3]], [0.0, 0.0, 1.0]])
    dist = p[4:9].reshape(1, 5)
    rvecs = tuple(p[9 + 6 * v:12 + 6 * v].reshape(3, 1) for v in range(n))
    tvecs = tuple(p[12 + 6 * v:15 + 6 * v].reshape(3, 1) for v in range(n))
    rms = float(np.sqrt(err / sum(len(o) for o in objs)))
    return rms, K, dist, rvecs, tvecs


# ---------------------------------------------------------------------------
# findChessboardCorners
# ---------------------------------------------------------------------------

_BORDER = 8          # cv2 rejects a board with a corner this close to the edge


def _dark_masks(gray: np.ndarray, squares: int):
    """Candidate masks of the dark squares, most likely first: the image's
    Otsu threshold, then below the local mean over windows of about two
    and one square sides of a board that fills the frame."""
    from scipy import ndimage

    hist = np.bincount(gray.ravel(), minlength=256).astype(np.float64)
    levels = np.arange(256)
    w0 = np.cumsum(hist)
    m0 = np.cumsum(hist * levels)
    w1 = w0[-1] - w0
    with np.errstate(divide="ignore", invalid="ignore"):
        between = w0 * w1 * (m0 / w0 - (m0[-1] - m0) / w1) ** 2
    if np.isfinite(between[:-1]).any():
        yield gray <= int(np.nanargmax(between[:-1]))
    side = np.sqrt(gray.size / squares)
    g = gray.astype(np.float64)
    for k in (2.0, 1.0):
        size = int(round(side * k)) | 1
        if size >= 3:
            yield g < ndimage.uniform_filter(g, size, mode="nearest")


def _quad(ys: np.ndarray, xs: np.ndarray):
    """The four corners of a convex blob (its pixel centres), in order
    around it: the two ends of the hull's diameter and the hull points
    farthest from it on either side. None when the blob is not a square
    under perspective (sides of like length, the blob filling the quad)."""
    from scipy.spatial import ConvexHull, QhullError

    pts = np.stack([xs, ys], 1).astype(np.float64)
    try:
        hull = pts[ConvexHull(pts).vertices]
    except QhullError:                 # a line of pixels
        return None
    d2 = ((hull[:, None] - hull[None]) ** 2).sum(-1)
    i, j = np.unravel_index(d2.argmax(), d2.shape)
    p, q = hull[i], hull[j]
    axis = q - p
    side = (hull - p) @ np.array([-axis[1], axis[0]]) / np.hypot(*axis)
    if side.max() <= 1 or side.min() >= -1:
        return None
    quad = np.stack([p, hull[side.argmax()], q, hull[side.argmin()]])
    edges = np.roll(quad, -1, 0) - quad
    lens = np.hypot(edges[:, 0], edges[:, 1])
    area = 0.5 * abs(np.sum(quad[:, 0] * np.roll(quad[:, 1], -1)
                            - np.roll(quad[:, 0], -1) * quad[:, 1]))
    if lens.min() < 0.3 * lens.max() or not 0.6 * len(pts) <= area <= 1.3 * len(pts):
        return None
    return quad


def _grid(nodes: np.ndarray, adj: List[set], cols: int, rows: int):
    """Order a component of the corner graph as a cols × rows grid (rows of
    ``cols`` node indices) or None when it is not one."""
    deg = np.array([len(a) for a in adj])
    corners = np.nonzero(deg == 2)[0]
    if len(corners) != 4 or np.any(deg > 4) or np.any(deg < 2):
        return None
    c0 = corners[0]

    def chain(start, nxt):
        out, prev = [start, nxt], start
        while deg[out[-1]] == 3:
            step = [n for n in adj[out[-1]] if n != prev and deg[n] <= 3 and n not in out]
            if len(step) != 1:
                return None
            prev = out[-1]
            out.append(step[0])
        return out if deg[out[-1]] == 2 else None

    a, b = sorted(adj[c0])
    first, side = chain(c0, a), chain(c0, b)
    if first is None or side is None:
        return None
    grid = [first]
    for i in range(1, len(side)):
        row = [side[i]]
        for j in range(1, len(first)):
            up = grid[i - 1][j]
            taken = {grid[i - 2][j]} if i >= 2 else set()
            taken |= {grid[i - 1][j - 1]} | ({grid[i - 1][j + 1]} if j + 1 < len(first) else set())
            cand = adj[up] - taken
            if len(cand) != 1:
                return None
            node = cand.pop()
            if node not in adj[row[-1]]:
                return None
            row.append(node)
        grid.append(row)
    g = np.array(grid)
    if len(np.unique(g)) != g.size:
        return None
    if g.shape == (cols, rows) and cols != rows:
        g = g.T
    return g if g.shape == (rows, cols) else None


def _corner_graph(mask: np.ndarray, min_area: int):
    """Inner-corner candidates and their adjacency from one dark mask: each
    blob's quad, corners of two blobs that meet paired into one node, the
    quads' sides between two nodes made edges."""
    from scipy import ndimage

    labels, n = ndimage.label(mask)
    if n < 2:
        return None
    H, W = mask.shape
    quads = []
    for k, sl in enumerate(ndimage.find_objects(labels), start=1):
        if sl is None:
            continue
        ys, xs = np.nonzero(labels[sl] == k)
        if len(ys) < min_area or sl[0].start == 0 or sl[1].start == 0 \
                or sl[0].stop == H or sl[1].stop == W:
            continue
        q = _quad(ys + sl[0].start, xs + sl[1].start)
        if q is not None:
            quads.append(q)
    if len(quads) < 2:
        return None
    quads = np.array(quads)                                    # (Q, 4, 2)
    sides = np.hypot(*(np.roll(quads, -1, 1) - quads).transpose(2, 0, 1)).min(1)   # (Q,)
    pts = quads.reshape(-1, 2)
    owner = np.repeat(np.arange(len(quads)), 4)
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    d2[owner[:, None] == owner[None, :]] = np.inf
    near = d2.argmin(1)
    limit = (0.4 * np.minimum(sides[owner], sides[owner[near]])) ** 2
    node_of = np.full(len(pts), -1)
    nodes = []
    for i, j in enumerate(near):
        if i < j and near[j] == i and d2[i, j] < limit[i]:
            node_of[i] = node_of[j] = len(nodes)
            nodes.append((pts[i] + pts[j]) * 0.5)
    if not nodes:
        return None
    adj = [set() for _ in nodes]
    for q in range(len(quads)):
        ids = node_of[4 * q:4 * q + 4]
        for c in range(4):
            u, v = ids[c], ids[(c + 1) % 4]
            if u >= 0 and v >= 0 and u != v:
                adj[u].add(v)
                adj[v].add(u)
    return np.array(nodes), adj, float(np.median(sides))


def _components(adj: List[set]):
    seen = np.zeros(len(adj), bool)
    for s in range(len(adj)):
        if seen[s]:
            continue
        comp, stack = [], [s]
        seen[s] = True
        while stack:
            u = stack.pop()
            comp.append(u)
            for v in adj[u]:
                if not seen[v]:
                    seen[v] = True
                    stack.append(v)
        yield comp


def _cv2_order(pts: np.ndarray, cols: int, rows: int) -> np.ndarray:
    """OpenCV's normalisation of a found grid ((rows, cols, 2)): the turn
    from the first row to the second clockwise on the image (else the rows
    are reversed when ``cols`` is odd, each row when it is even); then, for
    even × even patterns, the first row above the last as OpenCV puts it.
    For other patterns OpenCV's choice between the two turns comes from its
    quad linking; the first row below the last is the one it made on the
    boards of ``tests/test_torch_calib.py``."""
    p0, p1, p2 = pts[0, 0], pts[0, -1], pts[1, 0]
    if (p1[0] - p0[0]) * (p2[1] - p1[1]) - (p1[1] - p0[1]) * (p2[0] - p1[0]) < 0:
        pts = pts[::-1] if cols % 2 else pts[:, ::-1]
    below = pts[-1, 0, 1] - pts[0, 0, 1] < 0
    if below != (cols % 2 == 1 or rows % 2 == 1):
        pts = pts[::-1, ::-1]
    return pts


def find_chessboard_corners(gray: np.ndarray, pattern_size: Tuple[int, int]):
    """The counterpart of ``cv2.findChessboardCorners(gray, (cols, rows),
    ADAPTIVE_THRESH | FAST_CHECK | NORMALIZE_IMAGE)`` on a uint8 gray image:
    ``(found, corners)`` with corners (cols·rows, 1, 2) float32 in OpenCV's
    order up to a turn by 180° (see the module docstring), refined as cv2
    refines them (``cornerSubPix`` over a 5 × 5 window), or ``(False,
    None)``. A board is found when every inner corner is, more than 8 px
    inside the image."""
    cols, rows = (int(v) for v in pattern_size)
    if cols < 2 or rows < 2:
        raise ValueError(f"pattern size must be at least 2x2, got {pattern_size}")
    gray = np.asarray(gray)
    if gray.ndim == 3:
        gray = cvnp.bgr2gray(gray)
    gray = np.ascontiguousarray(gray, np.uint8)
    H, W = gray.shape
    from scipy import ndimage

    squares = (cols + 1) * (rows + 1)
    min_area = max(9, int(gray.size / squares / 400))
    for mask in _dark_masks(gray, squares):
        for erosion in (1, 2, 3):
            eroded = ndimage.binary_erosion(mask, np.ones((3, 3), bool), iterations=erosion)
            graph = _corner_graph(eroded, min_area)
            if graph is None:
                continue
            nodes, adj, side = graph
            for comp in _components(adj):
                if len(comp) != cols * rows:
                    continue
                local = {u: k for k, u in enumerate(comp)}
                grid = _grid(nodes[comp], [{local[v] for v in adj[u]} for u in comp],
                             cols, rows)
                if grid is None:
                    continue
                pts = _cv2_order(nodes[comp][grid], cols, rows).reshape(-1, 2)
                win = int(np.clip(round(side * 0.25), 2, 5))
                pts = cvnp.corner_sub_pix(gray, cvnp.corner_sub_pix(gray, pts, win, 30, 0.01), 2, 15, 0.1)
                if np.all((pts[:, 0] > _BORDER) & (pts[:, 0] <= W - _BORDER)
                          & (pts[:, 1] > _BORDER) & (pts[:, 1] <= H - _BORDER)):
                    return True, pts.reshape(-1, 1, 2).astype(np.float32)
                return False, None
    return False, None

"""Temporal pose filtering for video streams (``deepcharuco_tpu.pose_filter``,
numpy only; the same floats).

:class:`PoseFilter` is a constant-velocity alpha-beta filter on SE(3) with
innovation gating:

- **rotation** is filtered on SO(3): the residual between the
  constant-velocity prediction and the measurement is the rotation-vector
  log of ``R_pred^T R_meas``, blended back with gain ``alpha`` and
  integrated into the angular-velocity state with gain ``beta``;
- **translation** is a standard alpha-beta filter;
- frames whose PnP failed (``ok=False``) or whose measurement innovation
  exceeds the gates (e.g. a planar-ambiguity twin flip) are **coasted**:
  the filter reports its prediction for up to ``max_coast`` consecutive
  frames, then declares the track lost and re-initializes on the next
  accepted measurement.

Host-side by design: poses are a few dozen bytes per frame and the filter
is sequential; the batched device program computes the measurements and the
filter smooths the stream as it is consumed.
"""

from __future__ import annotations

import numpy as np


def _rodrigues(r):
    """Rotation vector → matrix (Rodrigues), pure numpy."""
    r = np.asarray(r, np.float64).reshape(3)
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _rodrigues_inv(R):
    """Rotation matrix → rotation vector, pure numpy (log map)."""
    R = np.asarray(R, np.float64)
    cos_th = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(cos_th)
    if th < 1e-12:
        return np.zeros(3)
    if th > np.pi - 1e-6:
        # near-pi: axis from the symmetric part
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        # fix signs from off-diagonals
        if axis[0] > 0:
            axis[1] = np.copysign(axis[1], A[0, 1])
            axis[2] = np.copysign(axis[2], A[0, 2])
        elif axis[1] > 0:
            axis[2] = np.copysign(axis[2], A[1, 2])
        axis = axis / max(np.linalg.norm(axis), 1e-12)
        return th * axis
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th / (2.0 * np.sin(th)) * v


class PoseFilter:
    """Constant-velocity SE(3) alpha-beta filter with innovation gating.

    Parameters
    ----------
    alpha, beta:
        Blend gains for the state and its velocity (0 < beta <= alpha <= 1).
        An alpha-beta filter tracks a constant-velocity trajectory with zero
        steady-state lag; alpha controls jitter rejection.
    gate_deg:
        Max rotation innovation (degrees) accepted per frame. A planar-PnP
        ambiguity twin flip measures tens of degrees and is rejected.
    gate_t:
        Max translation innovation (same units as tvec — metres for a board
        with square_len in metres).
    max_coast:
        Consecutive rejected/failed frames the filter predicts through
        before declaring the track lost.
    """

    def __init__(self, alpha: float = 0.6, beta: float = 0.2,
                 gate_deg: float = 15.0, gate_t: float = 0.05,
                 max_coast: int = 5):
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.gate_rad = float(np.deg2rad(gate_deg))
        self.gate_t = float(gate_t)
        self.max_coast = int(max_coast)
        self.reset()

    def reset(self):
        self._R = None          # filtered rotation (3,3)
        self._t = None          # filtered translation (3,)
        self._w = np.zeros(3)   # angular velocity (rotvec / frame, body)
        self._v = np.zeros(3)   # translational velocity / frame
        self._coast = 0

    @property
    def tracking(self) -> bool:
        return self._R is not None

    def update(self, ok: bool, rvec, tvec):
        """Feed one frame's PnP output; get the filtered pose.

        Returns ``(ok, rvec, tvec, state)`` with state one of
        ``"tracking"`` (measurement accepted), ``"coasting"`` (prediction
        reported; measurement absent or gated), ``"lost"`` (no usable
        track — ok is False and the pose is the raw input).
        """
        meas_R = _rodrigues(rvec) if ok else None
        meas_t = (np.asarray(tvec, np.float64).reshape(3)
                  if ok else None)

        if self._R is None:
            if not ok:
                return False, np.asarray(rvec), np.asarray(tvec), "lost"
            self._R, self._t = meas_R, meas_t
            self._w[:] = 0.0
            self._v[:] = 0.0
            self._coast = 0
            return True, _rodrigues_inv(self._R), self._t.copy(), "tracking"

        # constant-velocity prediction
        R_pred = self._R @ _rodrigues(self._w)
        t_pred = self._t + self._v

        accept = False
        if ok:
            r_res = _rodrigues_inv(R_pred.T @ meas_R)
            t_res = meas_t - t_pred
            accept = (np.linalg.norm(r_res) <= self.gate_rad
                      and np.linalg.norm(t_res) <= self.gate_t)

        if accept:
            self._R = R_pred @ _rodrigues(self.alpha * r_res)
            self._w = self._w + self.beta * r_res
            self._t = t_pred + self.alpha * t_res
            self._v = self._v + self.beta * t_res
            self._coast = 0
            return True, _rodrigues_inv(self._R), self._t.copy(), "tracking"

        # coast on the prediction
        self._coast += 1
        if self._coast > self.max_coast:
            self.reset()
            if ok:  # gated-but-present measurement restarts the track
                return self.update(ok, rvec, tvec)
            return False, np.asarray(rvec), np.asarray(tvec), "lost"
        self._R, self._t = R_pred, t_pred
        return True, _rodrigues_inv(self._R), self._t.copy(), "coasting"

"""Measure ``deepcharuco_tpu_torch.calib.calibrate_camera`` against
``cv2.calibrateCamera`` (needs cv2; CPU only).

1. The gap on synthetic views that determine the camera: 4 seeds of 10
   views of a 9×6 grid by a distorted camera with 0.2 px noise (the views
   of ``tests/test_torch_calib.py``), both flag sets: K relative to fx,
   dist absolute, rms relative, rvecs and tvecs absolute.
2. cv2's iteration budget on views that do not: the five near-frontal
   boards of ``tests/test_cli.py`` (cv2's corners stored in the fixture as
   ``calib/chess/corners``) under the full distortion model, cv2's fx with
   no ``criteria`` and with explicit counts, beside the port's fx.

Run from the repository root: ``python scripts/probe_torch_port_calib.py``.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main():
    import cv2

    from deepcharuco_tpu_torch import calib
    from test_torch_calib import FIXTURE, synthetic_views

    worst = {}
    for seed in range(4):
        objs, imgs = synthetic_views(seed)
        for flags in (0, cv2.CALIB_ZERO_TANGENT_DIST | cv2.CALIB_FIX_K3):
            rms, K, dist, rv, tv = cv2.calibrateCamera(objs, imgs, (640, 480), None, None,
                                                       flags=flags)
            got = calib.calibrate_camera(objs, imgs, (640, 480), flags)
            gaps = {"K/fx": np.abs(got[1] - K).max() / K[0, 0],
                    "dist": np.abs(got[2] - dist).max(), "rms": abs(got[0] - rms) / rms,
                    "rvec": np.abs(np.array(got[3]) - np.array(rv)).max(),
                    "tvec": np.abs(np.array(got[4]) - np.array(tv)).max()}
            worst = {k: max(v, worst.get(k, 0.0)) for k, v in gaps.items()}
            print(f"seed {seed} flags {flags}: " + ", ".join(f"{k} {v:.2e}"
                                                            for k, v in gaps.items()))
    print("largest gaps:", {k: f"{v:.2e}" for k, v in worst.items()})

    with np.load(FIXTURE) as z:
        corners = z["calib/chess/corners"]
    objp = np.zeros((54, 3), np.float32)
    objp[:, :2] = np.mgrid[0:9, 0:6].T.reshape(-1, 2)
    objs = [objp] * len(corners)
    imgs = [c.reshape(-1, 1, 2).astype(np.float32) for c in corners]
    fx = cv2.calibrateCamera(objs, imgs, (640, 480), None, None)[1][0, 0]
    print(f"five near-frontal boards, flags 0: cv2 fx {fx:.3f} with no criteria")
    for count in (1, 30, 499, 500, 5000):
        crit = (cv2.TERM_CRITERIA_COUNT + cv2.TERM_CRITERIA_EPS, count, calib.DBL_EPSILON)
        K = cv2.calibrateCamera(objs, imgs, (640, 480), None, None, criteria=crit)[1]
        print(f"  cv2 fx {K[0, 0]:.3f} at a count of {count}")
    print(f"  port fx {calib.calibrate_camera(objs, imgs, (640, 480))[1][0, 0]:.3f} "
          "(500 trials)")


if __name__ == "__main__":
    main()

"""Evaluation and video helpers (``deepcharuco_tpu.utils``).

``compute_l2_distance``/``pixel_error`` take the reference's loose
``(x, y, id)`` keypoint rows (numpy); ``save_video`` writes an mp4 through
cv2, imported when it is called.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def compute_l2_distance(keypoints, ids, target_keypoints, target_ids):
    """Per unique target id, the largest L2 distance between the keypoints
    and the targets of that id (0 where either side lacks it), in a vector
    as long as ``target_ids``. None when there are no target ids."""
    target_ids = np.asarray(target_ids)
    if target_ids.size == 0:
        return None
    keypoints, ids = np.asarray(keypoints), np.asarray(ids)
    target_keypoints = np.asarray(target_keypoints)
    distances = np.zeros(len(target_ids))
    for i, tid in enumerate(np.unique(target_ids)):
        m, tm = ids == tid, target_ids == tid
        if not m.any() or not tm.any():
            continue
        d = np.linalg.norm(keypoints[m][:, None, :] - target_keypoints[tm][None, :, :],
                           axis=-1)
        distances[i] = d.max()
    return distances


def pixel_error(kpts_raw, kpts_ref, kpts_target,
                verbose: bool = True) -> Tuple[Optional[float], Optional[float]]:
    """Raw and refined corner rows (x, y, id) against target rows: (mean raw
    error, mean refined error), (None, None) when a raw id is not a target
    id or there are no targets."""
    if not set(kpts_raw[:, 2]).issubset(set(kpts_target[:, 2])):
        return None, None
    d = compute_l2_distance(kpts_raw[:, :2], kpts_raw[:, 2],
                            kpts_target[:, :2], kpts_target[:, 2])
    d_ref = compute_l2_distance(kpts_ref[:, :2], kpts_ref[:, 2],
                                kpts_target[:, :2], kpts_target[:, 2])
    if d is None or d_ref is None:
        return None, None
    if verbose:
        found = np.unique(kpts_raw[:, 2])
        print(f"Errors in pixels of the {len(found)}/{len(kpts_target)} kpts found:")
        print(f"Mean error raw: {d.mean():.3f}  max: {d.max():.3f}")
        print(f"Mean error ref: {d_ref.mean():.3f}  max: {d_ref.max():.3f}")
    return float(d.mean()), float(d_ref.mean())


def save_video(frames, output_path: str, fps: int = 30):
    """Write BGR frames to an mp4 (needs cv2)."""
    import cv2

    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for frame in frames:
        writer.write(frame)
    writer.release()
    print(f"Saved video to {os.path.abspath(output_path)}")

"""ChArUco board geometry: the numpy part of ``deepcharuco_tpu.board``.

:func:`inner_corner_object_points` is what the pose solver reads: slot ``k``
of the decode holds corner id ``k``, whose board-plane position is row ``k``
here. The cv2-backed construction and rendering of the JAX package's module
are not part of the port yet (ROADMAP.md, Open items); nothing here imports
cv2.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _inner_grid(row_count: int, col_count: int) -> np.ndarray:
    """(n_ids, 2) grid indices ``meshgrid(1..rows-1, 1..cols-1)``, id order."""
    return np.array(np.meshgrid(np.arange(1, row_count),
                                np.arange(1, col_count))).reshape((2, -1)).T


def inner_corner_object_points(row_count: int, col_count: int,
                               square_len: float) -> np.ndarray:
    """3-D object points of the board's inner corners, indexed by corner id:
    the inner grid times ``square_len`` in the z=0 plane, (n_ids, 3) float32."""
    pts = np.zeros((n_inner_corners(row_count, col_count), 3), np.float32)
    pts[:, :2] = _inner_grid(row_count, col_count) * square_len
    return pts


def inner_corner_pixels(resolution_wh: Tuple[int, int], row_count: int,
                        col_count: int) -> np.ndarray:
    """Pixel positions of the inner corners in a rendered board image:
    the inner grid times (W/cols, H/rows), cast to int. (n_ids, 2) in (x, y)."""
    pixel_offset = np.array([resolution_wh[0] / col_count,
                             resolution_wh[1] / row_count])
    return (_inner_grid(row_count, col_count) * pixel_offset).astype(int)


def n_inner_corners(row_count: int, col_count: int) -> int:
    return (row_count - 1) * (col_count - 1)

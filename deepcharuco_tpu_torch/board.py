"""ChArUco board geometry: the numpy part of ``deepcharuco_tpu.board``.

:func:`inner_corner_object_points` is what the pose solver reads: slot ``k``
of the decode holds corner id ``k``, whose board-plane position is row ``k``
here. The cv2-backed construction and rendering of the JAX package's module
are not part of the port (ROADMAP.md, Open items); nothing here imports
cv2. The on-card synthesis reads the board's render from an asset that
``scripts/make_torch_port_board.py`` writes with the JAX package's
renderer: :func:`rendered_board`.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                     "board_renders.npz")


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


def render_key(config, size: int) -> str:
    """The asset's key prefix for ``config``'s board rendered at size×size:
    everything the render depends on."""
    return (f"{config.board_name}_{config.row_count}x{config.col_count}_"
            f"{config.square_len}_{config.marker_len}_{size}")


def rendered_board(config, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The board of ``config`` rendered at size×size, as stored in the asset:
    (gray uint8 (size, size), inner-corner pixels (n_ids, 2) int32 in (x, y)).
    Raises ``KeyError`` for a board or size the asset does not hold."""
    key = render_key(config, size)
    with np.load(ASSET) as z:
        if f"{key}/image" not in z.files:
            held = sorted(k[:-len("/image")] for k in z.files if k.endswith("/image"))
            raise KeyError(f"no board render {key!r} in {ASSET} (it holds {held}); "
                           "add it with scripts/make_torch_port_board.py")
        return z[f"{key}/image"], z[f"{key}/corners"]

"""ChArUco board geometry, rendering and the cv2 helpers
(``deepcharuco_tpu.board``).

:func:`inner_corner_object_points` is what the pose solver reads: slot ``k``
of the decode holds corner id ``k``, whose board-plane position is row ``k``
here. :func:`rendered_board` is the board image the on-card synthesis
pastes: read from the asset where it is stored, else drawn in numpy by
:func:`render_charuco` from the ArUco dictionary bits the asset also holds
(``scripts/make_torch_port_board.py`` writes both with cv2), so any board
renders at any size without cv2. The cv2-backed helpers of the JAX module
(board construction, classical marker detection, drawing) import cv2
inside each function: the card's machine has no cv2.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                     "board_renders.npz")

# Predefined dictionaries whose markers are the first N of the 1000-marker
# dictionary of the same bit size (cv2 builds them so); the asset stores
# the 1000-marker sets and the dictionaries that stand alone.
_PREFIX_OF = {f"DICT_{b}X{b}_{n}": f"DICT_{b}X{b}_1000"
              for b in (4, 5, 6, 7) for n in (50, 100, 250)}


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


# ---------------------------------------------------------------------------
# Rendering without cv2
# ---------------------------------------------------------------------------

def aruco_bits(board_name: str) -> np.ndarray:
    """The inner bits of every marker of a predefined ArUco dictionary, as
    the asset stores them: (n_markers, bits, bits) bool, True = white.
    Names are cv2's (``DICT_APRILTAG_36h11`` and ``..._36H11`` alike)."""
    board_name = board_name.upper()
    key = f"aruco/{_PREFIX_OF.get(board_name, board_name)}"
    with np.load(ASSET) as z:
        if key not in z.files:
            held = sorted(k[len("aruco/"):] for k in z.files if k.startswith("aruco/"))
            raise KeyError(f"no ArUco dictionary {board_name!r} in {ASSET} (it holds "
                           f"{held}); add it with scripts/make_torch_port_board.py --dicts")
        bits = z[key].astype(bool)
    if board_name in _PREFIX_OF:
        bits = bits[:int(board_name.rsplit("_", 1)[1])]
    return bits


def _nearest_resize(tiny: np.ndarray, side: int) -> np.ndarray:
    """Nearest-neighbour upscale of a square image to side×side:
    source index floor(i · n/side), as ``cv2.resize(INTER_NEAREST)``."""
    n = tiny.shape[0]
    idx = np.minimum(np.floor(np.arange(side) * (1.0 / (side / n))).astype(int), n - 1)
    return tiny[idx][:, idx]


def _fit(extent_x: float, extent_y: float, w: int, h: int) -> Tuple[int, int, int, int]:
    """(x0, y0, w, h) of the largest region of a w×h canvas with the aspect
    of extent_x : extent_y, centered along the axis it leaves room on."""
    rx, ry = extent_x / w, extent_y / h
    if rx > ry:
        n = int(np.rint(extent_y / rx))
        return 0, (h - n) // 2, w, n
    n = int(np.rint(extent_x / ry))
    return (w - n) // 2, 0, n, h


def render_charuco(config, size: int, bits=None) -> np.ndarray:
    """The ChArUco board of ``config`` drawn at size×size as
    ``CharucoBoard.generateImage`` draws it (gray uint8, 255 = white), from
    the dictionary's bits (``bits`` None → :func:`aruco_bits`). The board
    fills the largest centered region of the board's aspect; squares take
    the rounded multiples of the square size in pixels; each marker (a
    one-bit black border around its bits) is scaled by nearest neighbour
    into the board-plane box its object points give, inside a margin of the
    rounded square-to-marker gap. Equal to cv2 5.0.0's render pixel for
    pixel on the default board at every size from 40 to 1000 px and on the
    boards ``tests/test_torch_board.py`` holds; on some layouts with more
    rows than columns (5 wide × 7 high) cv2 places a marker one pixel
    apart at some sizes, which this rule does not reproduce."""
    cols, rows = config.col_count, config.row_count
    if bits is None:
        bits = aruco_bits(config.board_name)
    f = np.float32
    sq, mk = f(config.square_len), f(config.marker_len)
    out = np.full((size, size), 255, np.uint8)
    zx, zy, zw, zh = _fit(float(f(sq * f(cols))), float(f(sq * f(rows))), size, size)
    zone = out[zy:zy + zh, zx:zx + zw]
    sq_px = min(zw / cols, zh / rows)
    gap = f(f(sq - mk) / f(2))
    margin = int(np.rint(float(gap) * sq_px / float(sq)))

    # markers on the white squares, ids in row-major order (board plane, float32)
    starts = [(f(f(x) * sq + gap), f(f(y) * sq + gap))
              for y in range(rows) for x in range(cols) if y % 2 != x % 2]
    if len(starts) > len(bits):
        raise ValueError(f"{config.board_name} has {len(bits)} markers, the board needs "
                         f"{len(starts)}")
    min_x = min(s[0] for s in starts)
    min_y = min(s[1] for s in starts)
    ext_x = f(max(f(s[0] + mk) for s in starts) - min_x)
    ext_y = f(max(f(s[1] + mk) for s in starts) - min_y)
    inner = zone[margin:zh - margin, margin:zw - margin]
    ih, iw = inner.shape
    rx, ry = f(ext_x / f(iw)), f(ext_y / f(ih))
    if rx > ry:
        n = int(np.rint(ext_y / rx))
        area = inner[(ih - n) // 2:(ih - n) // 2 + n, :]
    else:
        n = int(np.rint(ext_x / ry))
        area = inner[:, (iw - n) // 2:(iw - n) // 2 + n]
    ah, aw = area.shape
    px = lambda v, lo, ext, span: f(f(f(v - lo) / ext) * f(span))
    n_bits = bits.shape[1]
    for i, (sx, sy) in enumerate(starts):
        x0, y0 = px(sx, min_x, ext_x, aw), px(sy, min_y, ext_y, ah)
        x1, y1 = px(f(sx + mk), min_x, ext_x, aw), px(f(sy + mk), min_y, ext_y, ah)
        side = min(int(np.rint(f(x1 - x0))), int(np.rint(f(y1 - y0))))
        tiny = np.zeros((n_bits + 2, n_bits + 2), np.uint8)
        tiny[1:-1, 1:-1] = bits[i] * 255
        c, r = int(np.rint(x0)), int(np.rint(y0))
        area[r:r + side, c:c + side] = _nearest_resize(tiny, side)

    # black squares where row and column have the same parity
    edge = lambda k: int(np.rint(sq_px * k))
    for y in range(rows):
        for x in range(cols):
            if y % 2 == x % 2:
                zone[edge(y):edge(y + 1), edge(x):edge(x + 1)] = 0
    return out


def render_key(config, size: int) -> str:
    """The asset's key prefix for ``config``'s board rendered at size×size:
    everything the render depends on."""
    return (f"{config.board_name}_{config.row_count}x{config.col_count}_"
            f"{config.square_len}_{config.marker_len}_{size}")


def rendered_board(config, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The board of ``config`` rendered at size×size: (gray uint8 (size,
    size), inner-corner pixels (n_ids, 2) int32 in (x, y)). The asset's
    stored render where it holds one, else :func:`render_charuco`."""
    key = render_key(config, size)
    with np.load(ASSET) as z:
        if f"{key}/image" in z.files:
            return z[f"{key}/image"], z[f"{key}/corners"]
    corners = inner_corner_pixels((size, size), config.row_count, config.col_count)
    return render_charuco(config, size), corners.astype(np.int32)


# ---------------------------------------------------------------------------
# cv2-backed construction, detection and drawing (cv2 imported lazily)
# ---------------------------------------------------------------------------

def _cv2():
    import cv2

    return cv2


def get_aruco_dict(board_name: str):
    """Predefined aruco dictionary by name, across cv2 API generations."""
    cv2 = _cv2()
    dict_id = getattr(cv2.aruco, board_name)
    if hasattr(cv2.aruco, "getPredefinedDictionary"):
        return cv2.aruco.getPredefinedDictionary(dict_id)
    return cv2.aruco.Dictionary_get(dict_id)


def get_board(config):
    """The cv2 CharucoBoard of ``config``, across API generations."""
    cv2 = _cv2()
    dictionary = get_aruco_dict(config.board_name)
    if hasattr(cv2.aruco, "CharucoBoard"):
        try:
            return cv2.aruco.CharucoBoard((config.col_count, config.row_count),
                                          config.square_len, config.marker_len,
                                          dictionary)
        except TypeError:
            pass
    return cv2.aruco.CharucoBoard_create(squaresX=config.col_count,
                                         squaresY=config.row_count,
                                         squareLength=config.square_len,
                                         markerLength=config.marker_len,
                                         dictionary=dictionary)


def board_image(board, resolution_wh: Tuple[int, int], row_count: int, col_count: int):
    """cv2's render of ``board``: (BGR image, inner-corner int pixel coords)."""
    cv2 = _cv2()
    if hasattr(board, "generateImage"):
        gray = board.generateImage(resolution_wh)
    else:
        gray = board.draw(outSize=resolution_wh)
    img = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
    return img, inner_corner_pixels(resolution_wh, row_count, col_count)


def create_detector_parameters():
    """cv2 aruco detector parameters, across API generations."""
    cv2 = _cv2()
    if hasattr(cv2.aruco, "DetectorParameters"):
        return cv2.aruco.DetectorParameters()
    return cv2.aruco.DetectorParameters_create()


def get_board_object_points(board) -> np.ndarray:
    """Marker object points of a cv2 board, (n_markers, 4, 3) float32."""
    if hasattr(board, "getObjPoints"):
        return np.array(board.getObjPoints(), dtype=np.float32)
    return np.array(board.objPoints, dtype=np.float32)


def _detect_markers(gray, dictionary, parameters):
    cv2 = _cv2()
    if hasattr(cv2.aruco, "ArucoDetector"):
        return cv2.aruco.ArucoDetector(dictionary, parameters).detectMarkers(gray)
    return cv2.aruco.detectMarkers(gray, dictionary, parameters=parameters)


def cv2_aruco_detect(image, dictionary, board, parameters):
    """The classical baseline: marker detection, board-aware refinement,
    annotation. Returns (annotated BGR image, marker corners, marker ids)."""
    cv2 = _cv2()
    gray = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
    corners, ids, rejected = _detect_markers(gray, dictionary, parameters)
    refine = getattr(cv2.aruco, "refineDetectedMarkers", None)
    if refine is not None and ids is not None:
        if rejected is None or len(rejected) == 0:
            rejected = np.empty((0, 1, 4, 2), np.float32)
        try:
            corners, ids, rejected, _ = refine(image, board, corners, ids, rejected)
        except (TypeError, cv2.error):
            corners, ids, rejected, _ = refine(image, board, corners, ids,
                                               np.empty((0, 1, 4, 2), np.float32))
    annotated = image
    if ids is not None and len(corners) > 0:
        pts = np.concatenate([np.asarray(c, np.float32).reshape(-1, 2) for c in corners])
        annotated = draw_inner_corners(image, pts, np.arange(len(pts)))
    return annotated, corners, ids


def draw_inner_corners(img, corners, ids, draw_ids: bool = False, radius: int = 2,
                       color=(0, 0, 255)):
    """Corner circles (+ optional green id labels) on a copy of a BGR image;
    points past the bottom/right edge are dropped."""
    cv2 = _cv2()
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected a BGR image (H, W, 3), got shape {img.shape}")
    canvas = img.copy()
    pts = np.round(np.asarray(corners, np.float64)[:, :2]).astype(int)
    labels = np.asarray(ids)
    keep = (pts[:, 0] <= img.shape[1]) & (pts[:, 1] <= img.shape[0])
    for x, y in pts[keep]:
        cv2.circle(canvas, (int(x), int(y)), radius=radius, color=color, thickness=1)
    if draw_ids:
        font = cv2.FONT_HERSHEY_COMPLEX_SMALL
        for (x, y), idx in zip(pts[keep], labels[keep]):
            text = str(idx)
            (tw, th), _ = cv2.getTextSize(text, font, 0.5, 1)
            cv2.putText(canvas, text, (int(x) - tw // 2 - 7, int(y) + th // 2 - 3),
                        font, 0.45, (0, 255, 0), 1)
    return canvas


def draw_keypoints_with_validity(img, keypoints, valid, draw_ids: bool = False,
                                 radius: int = 2, color=(0, 255, 255)):
    """Draw the decode's fixed-capacity (n_ids, 2) keypoints where valid."""
    kpts = np.asarray(keypoints)
    valid = np.asarray(valid)
    ids = np.arange(kpts.shape[0])
    return draw_inner_corners(img, kpts[valid], ids[valid], draw_ids=draw_ids,
                              radius=radius, color=color)

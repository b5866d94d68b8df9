"""The cv2 calls of the host data pipeline, restated in numpy.

The card's machine has no OpenCV, and the JAX package's host pipeline
(``deepcharuco_tpu.data``) is numpy plus cv2. Each cv2 call it makes is
written out here with OpenCV 5.0.0's own arithmetic: its fixed-point tables,
its float32 rounding points, and a fused multiply-add where its vector code
uses one (:func:`_fma32`). Every function names the call it stands for and
how close it comes to cv2 5.0.0 as built with Intel IPP 2026.0.0
(``tests/test_torch_data.py`` holds each one to that):

- ``cvtColor`` BGR→GRAY, BGR↔HSV, ``flip``, ``warpAffine`` (linear and
  nearest, constant border 0, 1 or 3 channels), ``resize`` INTER_AREA at an
  integer factor, INTER_NEAREST, ``GaussianBlur``, ``circle`` (filled, and
  one pixel wide), ``applyColorMap`` (viridis): bit-equal.
- ``resize`` INTER_LINEAR of uint8 images: OpenCV's 11-bit fixed point with
  its vector code's rounding; bit-equal on every shape the tests try (cv2
  does not hand it to IPP).
- ``resize`` INTER_CUBIC: bit-equal to OpenCV's own code; cv2 hands uint8
  cubic resizes to IPP, which differs from it by one level on a few values
  in a million (``PERF.md`` §6 gives the measured share).
- ``getRotationMatrix2D``: the same double arithmetic.
- ``resize`` INTER_AREA at other ratios: within one level.
- ``cornerSubPix`` (with ``getRectSubPix``): the same float32 sampling, the
  sums in float64 in another order; within 1e-3 px.
- ``filter2D``: the same taps and rounding, within one level.
- ``resize`` INTER_LINEAR of float32 images: within 1e-4.

All functions take and return numpy arrays in cv2's layout (H, W[, C]) and
never modify their inputs, but :func:`circle_filled` and :func:`circle`,
which draw in place as ``cv2.circle`` does.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

f32 = np.float32


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a·b + c`` rounded once, as a hardware FMA does. The product
    of two float32 values is exact in float64; the float64 sum then rounds
    twice (to 53 bits, then 24), which differs from one rounding only when
    the first lands exactly on a float32 midpoint."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(f32)


def _round_u8(v: np.ndarray) -> np.ndarray:
    """``saturate_cast<uchar>`` of a float: round half to even, clamp."""
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Colour
# ---------------------------------------------------------------------------

def bgr2gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)`` on uint8: bit-equal on all
    2^24 colours. OpenCV 5's fixed point has 15 fractional bits:
    (3735·B + 19235·G + 9798·R + 2^14) >> 15 (the 14-bit 1868/9617/4899 of
    older releases differs on 0.26% of colours)."""
    px = img.astype(np.uint32)
    return ((px[..., 0] * 3735 + px[..., 1] * 19235 + px[..., 2] * 9798 + (1 << 14))
            >> 15).astype(np.uint8)


_HSV_SHIFT = 12


def _div_table(num: float) -> np.ndarray:
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        t = np.rint(num / np.where(i == 0, 1.0, i))
    t[0] = 0
    return t.astype(np.int64)


_SDIV = _div_table(255 << _HSV_SHIFT)
_HDIV180 = _div_table((180 << _HSV_SHIFT) / 6.0)


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` on uint8 (H in [0, 180)):
    bit-equal. OpenCV's integer tables: S = diff·round(255·2^12 / V), H by
    sector times round(180·2^12 / (6·diff)), both rounded and shifted by 12."""
    px = img.astype(np.int64)
    b, g, r = px[..., 0], px[..., 1], px[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([np.clip(h, 0, 255), s, v], axis=-1).astype(np.uint8)


# sector → which of (v, v(1−s), v(1−s·h), v(1−s(1−h))) is B, G, R
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


_HSV_VECTOR_PIXELS = 32     # pixels per step of cv2's AVX2 HSV→BGR loop


def hsv2bgr(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2BGR)`` on uint8 (H in [0, 180)):
    bit-equal on all 180·256·256 inputs, in rows of any width. OpenCV's
    float32 route: S and V scaled by 1/255, H by 6/180, the sector table
    (1 − s·h and 1 − s·(1 − h) each an FMA), then each channel ×255. Its
    vector loop (AVX2: 32 pixels a step, from the start of each row)
    truncates that product; the scalar loop over the rest of the row rounds
    it half to even."""
    h = img[..., 0].astype(f32) * (f32(6.0) / f32(180.0))
    s = img[..., 1].astype(f32) * (f32(1.0) / f32(255.0))
    v = img[..., 2].astype(f32) * (f32(1.0) / f32(255.0))
    h = np.fmod(h, f32(6.0))
    sector = np.floor(h)
    h = h - sector
    sector = sector.astype(np.int64)
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    h = np.where(bad, f32(0.0), h)
    one = f32(1.0)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, h, one), v * _fma32(-s, one - h, one)],
                   axis=-1)
    out = np.take_along_axis(tab, _HSV_SECTORS[sector], axis=-1)
    out = np.where((s == 0)[..., None], v[..., None], out) * f32(255.0)
    width = img.shape[-2]
    vector = np.arange(width) < width // _HSV_VECTOR_PIXELS * _HSV_VECTOR_PIXELS
    out = np.where(vector[:, None], np.trunc(out), np.rint(out))
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

def flip(img: np.ndarray, code: int) -> np.ndarray:
    """``cv2.flip``: 0 flips the rows, a positive code the columns, a
    negative code both. Bit-equal (a copy)."""
    if code == 0:
        return img[::-1].copy()
    if code > 0:
        return img[:, ::-1].copy()
    return img[::-1, ::-1].copy()


def rotation_matrix_2d(center: Tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the same double arithmetic (the centre
    passes through float32, as cv2's ``Point2f``)."""
    cx, cy = float(f32(center[0])), float(f32(center[1]))
    a = angle * (np.pi / 180.0)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def invert_affine(M: np.ndarray) -> np.ndarray:
    """The inverse that ``cv2.warpAffine`` computes (double, as
    ``imgwarp.cpp`` writes it out): (6,) float64."""
    m = [float(v) for v in np.asarray(M, np.float64).ravel()]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.array(m, np.float64)


def _source_coords(M: np.ndarray, rows: range, cols: range):
    """float32 source coordinates of the destination pixels ``rows`` ×
    ``cols``, as OpenCV 5's warp kernels compute them: the inverse cast to
    float32, the row term ``y·M1 + M2`` rounded twice, then one FMA with
    ``x·M0``. Each pixel's coordinates depend on its own (x, y) only."""
    m = invert_affine(M).astype(f32)
    ys = np.arange(rows.start, rows.stop, dtype=f32)
    xs = np.arange(cols.start, cols.stop, dtype=f32)[None, :]
    row_x = (ys * m[1] + m[2])[:, None]
    row_y = (ys * m[4] + m[5])[:, None]
    return _fma32(m[0], xs, row_x), _fma32(m[3], xs, row_y)


def warp_affine(img: np.ndarray, M: np.ndarray, size_hw: Tuple[int, int],
                nearest: bool = False, window=None) -> np.ndarray:
    """``cv2.warpAffine(img, M, (W, H), flags=INTER_LINEAR or INTER_NEAREST,
    borderMode=BORDER_CONSTANT, borderValue=0)`` on uint8 with 1 or 3
    channels: bit-equal to cv2 5.0.0. OpenCV 5 maps each pixel in float32
    (:func:`_source_coords`); nearest rounds half to even; linear blends
    ``p00 + ax·(p01 − p00)`` along x, then along y, each an FMA in float32,
    and rounds half to even. Taps outside the source read 0.

    ``window=(y0, y1, x0, x1)`` computes only that part of the (H, W)
    result, equal to ``warp_affine(...)[y0:y1, x0:x1]``."""
    src = img if img.ndim == 3 else img[..., None]
    sh, sw, c = src.shape
    y0, y1, x0, x1 = window if window is not None else (0, size_hw[0], 0, size_hw[1])
    h, w = y1 - y0, x1 - x0
    out = np.zeros((c, h, w), np.uint8)
    sx, sy = _source_coords(M, range(y0, y1), range(x0, x1))
    if nearest:
        ix, iy = np.rint(sx), np.rint(sy)
        live = (ix >= 0) & (ix < sw) & (iy >= 0) & (iy < sh)
        idx = iy[live].astype(np.intp) * sw + ix[live].astype(np.intp)
        for k in range(c):
            out[k][live] = src[..., k].ravel().take(idx)
        return _interleave(out, img.ndim)
    fx, fy = np.floor(sx), np.floor(sy)
    # a pixel with no tap inside the source is 0
    live = (fx >= -1) & (fx <= sw - 1) & (fy >= -1) & (fy <= sh - 1)
    n_live = np.count_nonzero(live)
    if n_live == 0:
        return _interleave(out, img.ndim)
    every = n_live == h * w
    pick = (lambda a: a.ravel()) if every else (lambda a: a[live])
    ax = (pick(sx) - pick(fx)).astype(np.float64)
    ay = (pick(sy) - pick(fy)).astype(np.float64)
    # one zero row/column around the source: an edge tap reads 0
    pw = sw + 2
    i00 = (pick(fy).astype(np.intp) + 1) * pw + (pick(fx).astype(np.intp) + 1)
    i01, i10, i11 = i00 + 1, i00 + pw, i00 + pw + 1
    plane = np.zeros((sh + 2, pw), np.float64)
    for k in range(c):
        plane[1:1 + sh, 1:1 + sw] = src[..., k]
        flat = plane.ravel()
        # float64 holds ax·(p01 − p00) + p00 exactly: one rounding, an FMA's
        p00, p10 = flat.take(i00), flat.take(i10)
        top = flat.take(i01)
        top -= p00
        top *= ax
        top += p00
        top = top.astype(f32)
        bot = flat.take(i11)
        bot -= p10
        bot *= ax
        bot += p10
        bot = bot.astype(f32)
        bot -= top
        v = bot.astype(np.float64)
        v *= ay
        v += top
        v = v.astype(f32)
        np.rint(v, out=v)
        np.clip(v, 0, 255, out=v)
        if every:
            out[k] = v.reshape(h, w)
        else:
            out[k][live] = v
    return _interleave(out, img.ndim)


def _interleave(planes: np.ndarray, ndim: int) -> np.ndarray:
    """(C, H, W) planes → (H, W, C), or (H, W) for a gray source."""
    return np.ascontiguousarray(np.moveaxis(planes, 0, -1)) if ndim == 3 else planes[0]


# ---------------------------------------------------------------------------
# Resizing
# ---------------------------------------------------------------------------

_RESIZE_BITS = 11          # INTER_RESIZE_COEF_BITS


def _cubic_coeffs(x: np.ndarray) -> np.ndarray:
    """OpenCV's ``interpolateCubic`` (A = −0.75) in float32: (n, 4)."""
    A = f32(-0.75)
    one, x1 = f32(1.0), x + f32(1.0)
    c0 = ((A * x1 - f32(5.0) * A) * x1 + f32(8.0) * A) * x1 - f32(4.0) * A
    c1 = ((A + f32(2.0)) * x - (A + f32(3.0))) * x * x + one
    y = one - x
    c2 = ((A + f32(2.0)) * y - (A + f32(3.0))) * y * y + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=-1)


def _cubic_axis(ssize: int, dsize: int):
    """Source taps (n, 4), clamped to the image, and the coefficients as
    OpenCV's uint8 route stores them: round(c · 2^11) (n, 4) int64."""
    scale = 1.0 / (dsize / ssize)
    fx = ((np.arange(dsize) + 0.5) * scale - 0.5).astype(f32)
    sx = np.floor(fx)
    coeffs = _cubic_coeffs((fx - sx).astype(f32))
    taps = np.clip(sx.astype(np.int64)[:, None] + np.arange(-1, 3)[None, :], 0, ssize - 1)
    return taps, np.rint(coeffs * f32(1 << _RESIZE_BITS)).astype(np.int64)


def resize_cubic(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=cv2.INTER_CUBIC)`` on uint8:
    bit-equal to OpenCV's own code (``cv2.ipp.setUseIPP(False)``). The
    horizontal pass sums integer taps × 2^11 coefficients; the vertical one
    runs in float32 as its vector code does, ``S0·b0 + (S1·b1 + (S2·b2 +
    S3·b3))`` with b = coefficient / 2^22, rounded half to even. cv2 with IPP
    on (its default) differs by one level on a few values in a million."""
    src = img if img.ndim == 3 else img[..., None]
    sh, sw = src.shape[:2]
    h, w = size_hw
    xt, xc = _cubic_axis(sw, w)
    yt, yc = _cubic_axis(sh, h)
    s32 = src.astype(np.int32)
    rows = sum(s32[:, xt[:, k]] * xc[None, :, k, None].astype(np.int32) for k in range(4))
    rows = rows.astype(f32)         # exact: |sum| < 2^24
    b = yc.astype(f32) * f32(1.0 / (1 << (2 * _RESIZE_BITS)))
    tap = lambda k: rows[yt[:, k]] * b[:, k, None, None]
    out = _round_u8(tap(0) + (tap(1) + (tap(2) + tap(3))))
    return out if img.ndim == 3 else out[..., 0]


def _area_weights(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) float64 share of each source pixel in each destination
    pixel for a downscale (the box of width ssize/dsize)."""
    scale = ssize / dsize
    lo = np.arange(dsize)[:, None] * scale
    hi = lo + scale
    j = np.arange(ssize)[None, :]
    overlap = np.clip(np.minimum(hi, j + 1) - np.maximum(lo, j), 0, None)
    return overlap / scale


def _area_up_weights(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) weights of OpenCV's INTER_AREA along an axis it does not
    shrink: linear taps at ``sx = floor(dx·scale)`` with the box-overlap
    fraction ``fx``."""
    scale = ssize / dsize
    inv = dsize / ssize
    d = np.arange(dsize)
    sx = np.floor(d * scale).astype(np.int64)
    fx = (d + 1) - (sx + 1) * inv
    fx = np.where(fx <= 0, 0.0, fx - np.floor(fx))
    out = np.zeros((dsize, ssize))
    out[d, np.clip(sx, 0, ssize - 1)] += 1 - fx
    out[d, np.clip(sx + 1, 0, ssize - 1)] += fx
    return out


def resize_area(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)`` on uint8.
    At an integer shrink factor (192² → 24²: 8) bit-equal: OpenCV's fast
    path sums each block as int, scales by the float32 1/area and rounds
    half to even. At other ratios the box-overlap weights in float64, within
    one level; where an axis grows, OpenCV's linear emulation of the area
    weights."""
    src = img if img.ndim == 3 else img[..., None]
    sh, sw, c = src.shape
    h, w = size_hw
    if sh % h == 0 and sw % w == 0 and sh >= h and sw >= w:
        fy, fx = sh // h, sw // w
        sums = src.reshape(h, fy, w, fx, c).astype(np.int64).sum(axis=(1, 3))
        out = _round_u8(sums.astype(f32) * (f32(1.0) / f32(fy * fx)))
    else:
        if sh >= h and sw >= w:
            wy, wx = _area_weights(sh, h), _area_weights(sw, w)
        else:
            wy, wx = _area_up_weights(sh, h), _area_up_weights(sw, w)
        cols = np.einsum("hs,swc->hwc", wy, src.astype(np.float64), optimize=True)
        v = np.einsum("hwc,xw->hxc", cols, wx, optimize=True)
        out = _round_u8(v)
    return out if img.ndim == 3 else out[..., 0]


def resize_linear_f32(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=cv2.INTER_LINEAR)`` on a
    float32 image: OpenCV's taps (``(d + 0.5)·scale − 0.5``, clamped at the
    borders) in float64, cast to float32; within 1e-4."""
    def axis(ssize, dsize):
        f = ((np.arange(dsize) + 0.5) * (ssize / dsize) - 0.5).astype(f32).astype(np.float64)
        s = np.floor(f)
        f = f - s
        s = s.astype(np.int64)
        f = np.where(s < 0, 0.0, f)
        s = np.maximum(s, 0)
        f = np.where(s >= ssize - 1, 0.0, f)
        s = np.minimum(s, ssize - 1)
        return s, np.minimum(s + 1, ssize - 1), f

    src = np.asarray(img, f32)
    x0, x1, fx = axis(src.shape[1], size_hw[1])
    y0, y1, fy = axis(src.shape[0], size_hw[0])
    fx = fx.astype(f32).reshape((1, -1) + (1,) * (src.ndim - 2))
    fy = fy.astype(f32).reshape((-1, 1) + (1,) * (src.ndim - 2))
    rows = src[:, x0] * (1 - fx) + src[:, x1] * fx
    return rows[y0] * (1 - fy) + rows[y1] * fy


def resize_nearest(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=cv2.INTER_NEAREST)``: source
    index ``floor(d · (1 / (dsize / ssize)))`` in double, clamped; bit-equal."""
    def taps(ssize, dsize):
        ifx = 1.0 / (dsize / ssize)
        return np.minimum(np.floor(np.arange(dsize) * ifx).astype(np.int64), ssize - 1)

    return np.ascontiguousarray(img[taps(img.shape[0], size_hw[0])][:, taps(img.shape[1],
                                                                            size_hw[1])])


def _linear_taps_fixed(ssize: int, dsize: int, clamp: bool):
    """OpenCV's INTER_LINEAR taps along one axis for 8-bit images: the
    float32 source position ``(d + 0.5)·scale − 0.5`` and the weights ``1 −
    f`` and ``f`` rounded to 11 bits. Along x (``clamp``) a position past
    either border takes the border pixel whole; along y OpenCV keeps the
    weights and clips only the two source rows."""
    scale = 1.0 / (dsize / ssize)
    fx = ((np.arange(dsize) + 0.5) * scale - 0.5).astype(f32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx.astype(f32)).astype(f32)
    if clamp:
        fx[(sx < 0) | (sx >= ssize - 1)] = 0
        sx = np.clip(sx, 0, ssize - 1)
    scale_c = f32(1 << _RESIZE_BITS)
    a0 = np.rint((f32(1) - fx) * scale_c).astype(np.int64)
    a1 = np.rint(fx * scale_c).astype(np.int64)
    return np.clip(sx, 0, ssize - 1), np.clip(sx + 1, 0, ssize - 1), a0, a1


def resize_linear_u8(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (W, H))`` (INTER_LINEAR) on a uint8 image: exact
    integer rows with 11-bit weights, then OpenCV's vertical blend as its
    vector code rounds it, ``((b0·(S0 >> 4)) >> 16 + (b1·(S1 >> 4)) >> 16 +
    2) >> 2`` (cv2 5.0.0 takes it for every column, the tail of a row too).
    An exact halving in both axes is INTER_AREA's 2 × 2 mean, as OpenCV
    routes it. Bit-equal to cv2 on every shape the tests try."""
    img = np.asarray(img)
    H, W = size_hw
    src = img.astype(np.int64)
    if img.shape[0] == 2 * H and img.shape[1] == 2 * W:
        s = src[0::2, 0::2] + src[1::2, 0::2] + src[0::2, 1::2] + src[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    x0, x1, a0, a1 = _linear_taps_fixed(img.shape[1], W, clamp=True)
    y0, y1, b0, b1 = _linear_taps_fixed(img.shape[0], H, clamp=False)
    cshape = (1, -1) + (1,) * (img.ndim - 2)
    rows = src[:, x0] * a0.reshape(cshape) + src[:, x1] * a1.reshape(cshape)   # (h, W[, C])
    s0 = rows[y0].reshape(H, -1)
    s1 = rows[y1].reshape(H, -1)
    b0, b1 = b0[:, None], b1[:, None]
    out = (((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape((H, W) + img.shape[2:])


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------

def _reflect101(n: int, r: int) -> np.ndarray:
    """Indices of a row padded by ``r`` under BORDER_REFLECT_101."""
    i = np.arange(-r, n + r)
    period = 2 * (n - 1) if n > 1 else 1
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


# OpenCV's fixed Gaussian kernels for ksize ≤ 7 and sigma ≤ 0, × 2^8
_SMALL_GAUSS = {1: [256], 3: [64, 128, 64], 5: [16, 64, 96, 64, 16],
                7: [8, 28, 56, 72, 56, 28, 8]}


def gaussian_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` on uint8, k in {1, 3, 5, 7}:
    bit-equal. OpenCV's fixed-point route: its tabulated kernels with 8
    fractional bits, exact integer sums both ways, rounded half up;
    BORDER_REFLECT_101."""
    if ksize not in _SMALL_GAUSS:
        raise ValueError(f"GaussianBlur ksize {ksize}: only 1, 3, 5, 7 are restated")
    src = img if img.ndim == 3 else img[..., None]
    k = [int(v) for v in _SMALL_GAUSS[ksize]]
    r = ksize // 2
    h, w = src.shape[:2]
    # numpy's "reflect" pad is BORDER_REFLECT_101 (the edge is not repeated)
    pad = np.pad(src.astype(np.int32), ((0, 0), (r, r), (0, 0)), mode="reflect")
    rows = sum(k[t] * pad[:, t:t + w] for t in range(ksize))
    pad = np.pad(rows, ((r, r), (0, 0), (0, 0)), mode="reflect")
    cols = sum(k[t] * pad[t:t + h] for t in range(ksize))
    out = ((cols + (1 << 15)) >> 16).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` on uint8 with a float32 kernel,
    anchor at the centre, BORDER_REFLECT_101: OpenCV's direct route, the
    kernel's non-zero taps in row-major order accumulated by float32 FMAs
    and rounded half to even; within one level."""
    src = img if img.ndim == 3 else img[..., None]
    kernel = np.asarray(kernel, f32)
    kh, kw = kernel.shape
    h, w = src.shape[:2]
    rows = _reflect101(h, kh // 2)
    cols = _reflect101(w, kw // 2)
    pad = src.astype(f32)[rows][:, cols]
    acc = None
    for i, j in zip(*np.nonzero(kernel)):
        tap = pad[i:i + h, j:j + w]
        acc = (tap * kernel[i, j]).astype(f32) if acc is None else _fma32(tap, kernel[i, j], acc)
    out = _round_u8(acc if acc is not None else np.zeros(src.shape, f32))
    return out if img.ndim == 3 else out[..., 0]


# ---------------------------------------------------------------------------
# Sub-pixel corners
# ---------------------------------------------------------------------------

def get_rect_sub_pix(img: np.ndarray, size_wh: Tuple[int, int],
                     center: Tuple[float, float]) -> np.ndarray:
    """``cv2.getRectSubPix(img, (w, h), center, patchType=CV_32F)`` on a
    uint8 gray image: OpenCV's float32 recurrence (``getRectSubPix_8u32f``)
    where the window lies inside the image, its bilinear blend with
    replicated borders elsewhere. (h, w) float32."""
    w, h = size_wh
    cx = f32(center[0]) - f32((w - 1) * 0.5)
    cy = f32(center[1]) - f32((h - 1) * 0.5)
    ipx, ipy = int(np.floor(cx)), int(np.floor(cy))
    H, W = img.shape[:2]
    if 0 <= ipx and ipx + w < W and 0 <= ipy and ipy + h < H:
        a = max(f32(cx - f32(ipx)), f32(0.0001))
        b = f32(cy - f32(ipy))
        one = f32(1.0)
        a12, a22 = a * (one - b), a * b
        b1, b2 = one - b, b
        s = (1.0 - float(a)) / float(a)
        win = img[ipy:ipy + h + 1, ipx:ipx + w + 1].astype(f32)
        top, bot = win[:-1], win[1:]
        prev0 = (one - a) * (b1 * top[:, 0] + b2 * bot[:, 0])
        t = a12 * top[:, 1:] + a22 * bot[:, 1:]                # (h, w)
        prev = np.concatenate([prev0[:, None],
                               (t[:, :-1].astype(np.float64) * s).astype(f32)], axis=1)
        return (prev + t).astype(f32)
    a, b = f32(cx - f32(ipx)), f32(cy - f32(ipy))
    one = f32(1.0)
    ys = np.clip(np.arange(ipy, ipy + h + 1), 0, H - 1)
    xs = np.clip(np.arange(ipx, ipx + w + 1), 0, W - 1)
    win = img[ys][:, xs].astype(f32)
    return (win[:-1, :-1] * ((one - a) * (one - b)) + win[:-1, 1:] * (a * (one - b))
            + win[1:, :-1] * ((one - a) * b) + win[1:, 1:] * (a * b)).astype(f32)


def corner_sub_pix(gray: np.ndarray, points, win: int, max_iter: int = 30,
                   eps: float = 0.1) -> np.ndarray:
    """``cv2.cornerSubPix(gray, points, (win, win), (-1, -1), (EPS + COUNT,
    max_iter, eps))`` on a uint8 gray image, for one point (2,) or many
    (..., 2), each on its own: OpenCV's iteration (Gaussian window weights,
    gradients of the float32 ``getRectSubPix`` patch, the 2×2 solve in
    double, a point kept where it moves more than ``win``); within 1e-3 px.
    float32, the shape of ``points``. The points go one at a time: most
    calls hold one, and on a few points numpy's calls on scalars and small
    windows cost less than on batched arrays."""
    pts = np.asarray(points, f32).reshape(-1, 2)
    ww = 2 * win + 1
    t = (np.arange(ww, dtype=f32) - f32(win)) / f32(win)
    g = np.exp(-(t * t)).astype(f32)
    mask = (g[:, None] * g[None, :]).astype(f32).astype(np.float64)
    p = (np.arange(ww) - win).astype(np.float64)
    px, py = p[None, :], p[:, None]
    h, w = gray.shape[:2]
    eps2 = max(eps, 0.0) ** 2
    out = np.empty_like(pts)
    for k, start in enumerate(pts):
        cx, cy = start[0], start[1]
        for _ in range(max(1, min(max_iter, 100))):
            sub = get_rect_sub_pix(gray, (ww + 2, ww + 2), (cx, cy))
            gx = (sub[1:-1, 2:] - sub[1:-1, :-2]).astype(np.float64)
            gy = (sub[2:, 1:-1] - sub[:-2, 1:-1]).astype(np.float64)
            gxx, gxy, gyy = gx * gx * mask, gx * gy * mask, gy * gy * mask
            a, b, c = gxx.sum(), gxy.sum(), gyy.sum()
            bb1 = (gxx * px + gxy * py).sum()
            bb2 = (gxy * px + gyy * py).sum()
            det = a * c - b * b
            if abs(det) <= np.finfo(np.float64).eps ** 2:
                break
            scale = 1.0 / det
            nx = f32(float(cx) + c * scale * bb1 - b * scale * bb2)
            ny = f32(float(cy) - b * scale * bb1 + a * scale * bb2)
            err = (float(nx) - float(cx)) ** 2 + (float(ny) - float(cy)) ** 2
            cx, cy = nx, ny
            if cx < 0 or cx >= w or cy < 0 or cy >= h or err <= eps2:
                break
        if abs(cx - start[0]) > win or abs(cy - start[1]) > win:
            cx, cy = start
        out[k] = cx, cy
    return out.reshape(np.shape(points))


# ---------------------------------------------------------------------------
# Drawing
# ---------------------------------------------------------------------------

def circle_filled(img: np.ndarray, center: Tuple[int, int], radius: int,
                  color: Sequence[float]) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, -1)`` (LINE_8, no shift):
    draws in place and returns ``img``. OpenCV's midpoint walk gives each
    row's span; bit-equal."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    color = np.asarray(color, np.float64)[: (img.shape[2] if img.ndim == 3 else 1)]
    value = color if img.ndim == 3 else color[0]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    spans = {}

    def hline(y, x1, x2):
        if 0 <= y < h:
            x1, x2 = max(x1, 0), min(x2, w - 1)
            if x1 <= x2:
                lo, hi = spans.get(y, (x1, x2))
                spans[y] = (min(lo, x1), max(hi, x2))

    while dx >= dy:
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and cy - dx < h and cy + dx >= 0:
            hline(cy - dy, x11, x12)
            hline(cy + dy, x11, x12)
            if x21 < w and x22 >= 0:
                hline(cy - dx, x21, x22)
                hline(cy + dx, x21, x22)
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    for y, (x1, x2) in spans.items():
        img[y, x1:x2 + 1] = value
    return img


def circle(img: np.ndarray, center: Tuple[int, int], radius: int,
           color: Sequence[float]) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, thickness=1)`` (LINE_8, no
    shift): OpenCV's midpoint walk, eight points a step, each dropped
    outside the image. Draws in place and returns ``img``; bit-equal."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    color = np.asarray(color, np.float64)[: (img.shape[2] if img.ndim == 3 else 1)]
    value = _round_u8(color) if img.ndim == 3 else _round_u8(color)[0]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    pts = []
    while dx >= dy:
        pts += [(cx - dx, cy - dy), (cx + dx, cy - dy), (cx - dx, cy + dy), (cx + dx, cy + dy),
                (cx - dy, cy - dx), (cx + dy, cy - dx), (cx - dy, cy + dx), (cx + dy, cy + dx)]
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    xy = np.array(pts)
    keep = (xy[:, 0] >= 0) & (xy[:, 0] < w) & (xy[:, 1] >= 0) & (xy[:, 1] < h)
    img[xy[keep, 1], xy[keep, 0]] = value
    return img


VIRIDIS_ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "assets", "viridis.npz")


def apply_colormap(gray: np.ndarray, name: str = "viridis") -> np.ndarray:
    """``cv2.applyColorMap(gray, cv2.COLORMAP_VIRIDIS)`` on a uint8 gray
    image: cv2's 256-entry BGR table, dumped into the asset by
    ``scripts/make_torch_port_colormap.py``; bit-equal. Viridis is the one
    map stored. (H, W, 3) uint8."""
    if name != "viridis":
        raise KeyError(f"colormap {name!r}: only viridis is stored ({VIRIDIS_ASSET})")
    with np.load(VIRIDIS_ASSET) as z:
        lut = z["bgr"]
    gray = np.asarray(gray)
    if gray.dtype != np.uint8 or gray.ndim != 2:
        raise ValueError(f"expected a uint8 (H, W) image, got {gray.dtype} {gray.shape}")
    return lut[gray]

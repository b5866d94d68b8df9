"""Host augmentation primitives (``deepcharuco_tpu.data.augment``), on numpy
and :mod:`deepcharuco_tpu_torch.data.cvnp` instead of cv2.

The reference composes albumentations transforms
(``src/transformations.py:22-118``); the JAX package implements the same
distribution semantics directly, and this module is its copy. Every
primitive takes an explicit ``np.random.Generator`` and consumes it in the
same calls, in the same order, with the same bounds as the JAX package's:
numpy's bounded ``integers`` takes a variable number of words from the bit
stream, so one different bound would put every later sample out of step.

Geometric transforms carry keypoints through the same matrix; keypoints that
leave the frame are dropped (``remove_invisible=True``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from deepcharuco_tpu_torch.data import cvnp


# ---------------------------------------------------------------------------
# Geometric
# ---------------------------------------------------------------------------

def pad_to_size(img: np.ndarray, size_hw: Tuple[int, int],
                keypoints: Optional[np.ndarray] = None, value: int = 0):
    """Centre-pad to at least (H, W) (A.PadIfNeeded, constant border)."""
    h, w = img.shape[:2]
    th, tw = max(size_hw[0], h), max(size_hw[1], w)
    top = (th - h) // 2
    left = (tw - w) // 2
    out = np.full((th, tw) + img.shape[2:], value, img.dtype)
    out[top:top + h, left:left + w] = img
    if keypoints is not None:
        keypoints = keypoints + np.array([left, top], keypoints.dtype)
    return out, keypoints


def affine_matrix(rng: np.random.Generator, size_hw: Tuple[int, int],
                  scale_range=(0.25, 0.9), rotate_deg=(-360, 360),
                  shear_deg=(-35, 35), translate_frac=(-0.45, 0.45)) -> np.ndarray:
    """Random 2×3 affine about the image centre: scale, rotation, shear, then
    translation (``transformations.py:34-37``; RefineNet narrows them)."""
    h, w = size_hw
    s = rng.uniform(*scale_range)
    ang = np.deg2rad(rng.uniform(*rotate_deg))
    shx = np.deg2rad(rng.uniform(*shear_deg))
    shy = np.deg2rad(rng.uniform(*shear_deg))
    tx = rng.uniform(*translate_frac) * w
    ty = rng.uniform(*translate_frac) * h

    c, si = np.cos(ang), np.sin(ang)
    R = np.array([[c, -si], [si, c]])
    Sh = np.array([[1.0, np.tan(shx)], [np.tan(shy), 1.0]])
    A = (R @ Sh) * s
    center = np.array([w / 2.0, h / 2.0])
    t = center + np.array([tx, ty]) - A @ center
    return np.concatenate([A, t[:, None]], axis=1)


def warp_affine(img: np.ndarray, M: np.ndarray, size_hw: Tuple[int, int],
                nearest: bool = False) -> np.ndarray:
    """``cv2.warpAffine`` with a constant 0 border (:func:`cvnp.warp_affine`)."""
    return cvnp.warp_affine(img, M, size_hw, nearest=nearest)


def transform_keypoints(keypoints: np.ndarray, M: np.ndarray) -> np.ndarray:
    if keypoints.size == 0:
        return keypoints.reshape(0, 2)
    return keypoints @ M[:, :2].T + M[:, 2]


def keypoints_in_bounds(keypoints: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Visibility mask (x in [0, W), y in [0, H)), the reference's ``inbound``
    (``data.py:104-105``)."""
    return ((keypoints[:, 0] >= 0) & (keypoints[:, 0] < size_hw[1])
            & (keypoints[:, 1] >= 0) & (keypoints[:, 1] < size_hw[0]))


def random_flip(rng, img: np.ndarray, p: float = 0.5) -> np.ndarray:
    """A.Flip: horizontal, vertical or both."""
    if rng.random() < p:
        code = rng.integers(-1, 2)  # -1 both, 0 vertical, 1 horizontal
        img = cvnp.flip(img, int(code))
    return img


def _rotate_crop_plan(rng, hw: Tuple[int, int], limit, p: float):
    """The draws of A.Rotate(crop_border=True) and what they imply: None (no
    rotation), or the rotation matrix and the rows and columns (two
    ``range``s) of the rotated image that the crop to the largest inscribed
    axis-aligned rectangle keeps."""
    if rng.random() >= p:
        return None
    ang = rng.uniform(*limit)
    h, w = hw
    M = cvnp.rotation_matrix_2d((w / 2, h / 2), ang, 1.0)
    a = np.deg2rad(abs(ang) % 180)
    if a > np.pi / 2:
        a = np.pi - a
    sin_a, cos_a = np.sin(a), np.cos(a)
    if w <= 0 or h <= 0:
        return M, range(h), range(w)
    long_side, short_side = max(w, h), min(w, h)
    if short_side <= 2 * sin_a * cos_a * long_side or abs(sin_a - cos_a) < 1e-10:
        x = 0.5 * short_side
        wr, hr = (x / sin_a, x / cos_a) if w >= h else (x / cos_a, x / sin_a)
    else:
        cos_2a = cos_a * cos_a - sin_a * sin_a
        wr = (w * cos_a - h * sin_a) / cos_2a
        hr = (h * cos_a - w * sin_a) / cos_2a
    wr, hr = int(max(1, wr)), int(max(1, hr))
    y0 = (h - hr) // 2
    x0 = (w - wr) // 2
    # exactly the rows and columns that rot[y0:y0 + hr, x0:x0 + wr] keeps
    return M, range(*slice(y0, y0 + hr).indices(h)), range(*slice(x0, x0 + wr).indices(w))


def random_rotate_crop(rng, img: np.ndarray, limit=(-180, 180), p: float = 0.5):
    """A.Rotate(crop_border=True): rotate about the centre and crop to the
    largest inscribed axis-aligned rectangle. Only that rectangle is warped."""
    plan = _rotate_crop_plan(rng, img.shape[:2], limit, p)
    if plan is None:
        return img
    M, rows, cols = plan
    if len(rows) == 0 or len(cols) == 0:
        return np.zeros((len(rows), len(cols)) + img.shape[2:], img.dtype)
    return cvnp.warp_affine(img, M, img.shape[:2],
                            window=(rows.start, rows.stop, cols.start, cols.stop))


def random_crop(rng, img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """A.RandomCrop to exactly (H, W); pads first if smaller."""
    img, _ = pad_to_size(img, size_hw)
    h, w = img.shape[:2]
    y0 = int(rng.integers(0, h - size_hw[0] + 1))
    x0 = int(rng.integers(0, w - size_hw[1] + 1))
    return img[y0:y0 + size_hw[0], x0:x0 + size_hw[1]]


def random_rotate_crop_then_crop(rng, img: np.ndarray, size_hw: Tuple[int, int],
                                 limit=(-180, 180), p: float = 0.5) -> np.ndarray:
    """``random_crop(rng, random_rotate_crop(rng, img, limit, p), size_hw)``
    with the same draws and the same result, warping only the pixels the
    final crop keeps."""
    plan = _rotate_crop_plan(rng, img.shape[:2], limit, p)
    if plan is None:
        return random_crop(rng, img, size_hw)
    M, rows, cols = plan
    y0, x0, hr, wr = rows.start, cols.start, len(rows), len(cols)
    th, tw = max(size_hw[0], hr), max(size_hw[1], wr)
    top, left = (th - hr) // 2, (tw - wr) // 2
    cy = int(rng.integers(0, th - size_hw[0] + 1)) - top
    cx = int(rng.integers(0, tw - size_hw[1] + 1)) - left
    out = np.zeros(tuple(size_hw) + img.shape[2:], img.dtype)
    ry0, ry1 = max(cy, 0), min(cy + size_hw[0], hr)
    rx0, rx1 = max(cx, 0), min(cx + size_hw[1], wr)
    if ry1 > ry0 and rx1 > rx0:
        out[ry0 - cy:ry1 - cy, rx0 - cx:rx1 - cx] = cvnp.warp_affine(
            img, M, img.shape[:2], window=(y0 + ry0, y0 + ry1, x0 + rx0, x0 + rx1))
    return out


def coarse_dropout(rng, img: np.ndarray, mask: np.ndarray,
                   keypoints: np.ndarray, kp_mask: np.ndarray,
                   max_holes=6, min_holes=1, hole_range=(16, 64),
                   fill_values=(None, 0, 128, 255)):
    """A.CoarseDropout OneOf (``transformations.py:39-48``): holes filled
    through the paste mask or with a constant grey; keypoints in a hole are
    dropped (``transformations.py:12-19``)."""
    h, w = img.shape[:2]
    n = int(rng.integers(min_holes, max_holes + 1))
    fill = fill_values[int(rng.integers(0, len(fill_values)))]
    img = img.copy()
    mask = mask.copy()
    kp_mask = kp_mask.copy()
    for _ in range(n):
        hh = int(rng.integers(hole_range[0], hole_range[1] + 1))
        hw_ = int(rng.integers(hole_range[0], hole_range[1] + 1))
        y0 = int(rng.integers(0, max(1, h - hh)))
        x0 = int(rng.integers(0, max(1, w - hw_)))
        if fill is None:
            mask[y0:y0 + hh, x0:x0 + hw_] = 0  # hole in the paste mask
        else:
            img[y0:y0 + hh, x0:x0 + hw_] = fill
        inside = ((keypoints[:, 0] >= x0) & (keypoints[:, 0] < x0 + hw_)
                  & (keypoints[:, 1] >= y0) & (keypoints[:, 1] < y0 + hh))
        kp_mask = kp_mask & ~inside
    return img, mask, kp_mask


# ---------------------------------------------------------------------------
# Photometric (uint8 BGR in/out; each with probability p)
# ---------------------------------------------------------------------------

def color_jitter(rng, img, p=0.5, contrast=0.2, saturation=0.2, hue=0.2):
    """A.ColorJitter(brightness=0): contrast, saturation and hue in random order."""
    if rng.random() >= p:
        return img
    out = img.astype(np.float32)
    for op in rng.permutation(3):
        if op == 0:  # contrast
            f = 1.0 + rng.uniform(-contrast, contrast)
            mean = out.mean()
            out = (out - mean) * f + mean
        elif op == 1:  # saturation
            f = 1.0 + rng.uniform(-saturation, saturation)
            gray = out @ np.array([0.114, 0.587, 0.299], np.float32)
            out = gray[..., None] + (out - gray[..., None]) * f
        else:  # hue: rotate in HSV space
            hsv = cvnp.bgr2hsv(np.clip(out, 0, 255).astype(np.uint8)).astype(np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(rng.uniform(-hue, hue) * 90)) % 180
            out = cvnp.hsv2bgr(hsv.clip(0, 255).astype(np.uint8)).astype(np.float32)
    return np.clip(out, 0, 255).astype(np.uint8)


def rgb_shift(rng, img, p=0.5, limit=20):
    if rng.random() >= p:
        return img
    shift = rng.integers(-limit, limit + 1, size=3)
    return np.clip(img.astype(np.int16) + shift[None, None, :], 0, 255).astype(np.uint8)


def gauss_noise(rng, img, p=0.5, var_range=(10.0, 50.0)):
    if rng.random() >= p:
        return img
    sigma = np.sqrt(rng.uniform(*var_range))
    noise = rng.normal(0, sigma, img.shape)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def motion_blur(rng, img, p=0.5, blur_limit=5):
    if rng.random() >= p:
        return img
    k = int(rng.integers(3, blur_limit + 1)) | 1
    kernel = np.zeros((k, k), np.float32)
    ang = rng.uniform(0, np.pi)
    dx, dy = np.cos(ang), np.sin(ang)
    for i in range(k):
        t = i - (k - 1) / 2
        x = int(round((k - 1) / 2 + t * dx))
        y = int(round((k - 1) / 2 + t * dy))
        kernel[np.clip(y, 0, k - 1), np.clip(x, 0, k - 1)] = 1.0
    kernel /= kernel.sum()
    return cvnp.filter2d(img, kernel)


def gaussian_blur(rng, img, p=0.25, blur_limit=(3, 7)):
    if rng.random() >= p:
        return img
    k = int(rng.integers(blur_limit[0] // 2, blur_limit[1] // 2 + 1)) * 2 + 1
    return cvnp.gaussian_blur(img, k)


def multiplicative_noise(rng, img, p=0.5, multiplier=(0.95, 1.05)):
    if rng.random() >= p:
        return img
    m = rng.uniform(*multiplier)
    return np.clip(img.astype(np.float32) * m, 0, 255).astype(np.uint8)


def random_brightness_contrast(rng, img, p=0.5,
                               brightness_limit=(-0.8, 0.35), contrast_limit=0.0):
    """A.RandomBrightnessContrast with the reference's darkening range
    (``transformations.py:115-116``)."""
    if rng.random() >= p:
        return img
    b = rng.uniform(*brightness_limit) if np.ndim(brightness_limit) else 0.0
    out = img.astype(np.float32) + b * 255.0
    if contrast_limit:
        c = 1.0 + rng.uniform(-contrast_limit, contrast_limit)
        out = out * c
    return np.clip(out, 0, 255).astype(np.uint8)


def match_histograms(image: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Per-channel histogram matching by CDF mapping, the vendored skimage
    ``match_histograms`` of the reference (``src/custom_aug/custom_aug.py:65-221``)."""
    out = np.empty_like(image)
    for c in range(image.shape[-1]) if image.ndim == 3 else [None]:
        src = image[..., c] if c is not None else image
        ref = reference[..., c] if c is not None else reference
        s_vals, s_inv, s_counts = np.unique(src.ravel(), return_inverse=True,
                                            return_counts=True)
        r_vals, r_counts = np.unique(ref.ravel(), return_counts=True)
        s_cdf = np.cumsum(s_counts) / src.size
        r_cdf = np.cumsum(r_counts) / ref.size
        mapped = np.interp(s_cdf, r_cdf, r_vals)
        res = mapped[s_inv].reshape(src.shape)
        if c is not None:
            out[..., c] = res.astype(image.dtype)
        else:
            out = res.astype(image.dtype)
    return out


def histogram_match_board(rng, board: np.ndarray, target: np.ndarray,
                          p: float = 0.0, blend=(0.5, 1.0)) -> np.ndarray:
    """Blend the board toward ``target``'s histogram with probability ``p``
    (off by default, as in the reference's live pipeline)."""
    if rng.random() >= p:
        return board
    ratio = rng.uniform(*blend)
    matched = match_histograms(board, target).astype(np.float32)
    return np.clip(board.astype(np.float32) * (1 - ratio) + matched * ratio,
                   0, 255).astype(np.uint8)


def photometric_pipeline(rng, img):
    """The reference's photometric stack (``transformations.py:104-117``)."""
    img = color_jitter(rng, img)
    img = rgb_shift(rng, img)
    img = gauss_noise(rng, img)
    img = motion_blur(rng, img)
    img = gaussian_blur(rng, img)
    img = multiplicative_noise(rng, img)
    img = random_brightness_contrast(rng, img)
    return img

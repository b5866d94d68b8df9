"""Host datasets: synthesised detector samples and RefineNet patch samples
(``deepcharuco_tpu.data.dataset``).

Label semantics:

- Detector labels (``src/data.py:14-51``): (H/8, W/8) int maps; ``loc``
  holds the pixel index in the cell (``offset_x + 8·offset_y``) or the
  dustbin 64, ``ids`` the corner id or the dustbin ``n_ids``. Two corners in
  one cell: the later one replaces the first with probability 1/2.
- RefineNet samples (``src/data_refinenet.py:41-91``): render at 2×, cut a
  region around each corner, upscale ×4 (cubic), refine the true corner with
  ``cornerSubPix``, translate by ±32 px at random, crop 192², shrink to 24²
  (area); the label is a 64×64 σ=2 Gaussian heatmap at the corner.

Plain indexable datasets; batching and prefetch are in
:mod:`deepcharuco_tpu_torch.data.prefetch`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from deepcharuco_tpu_torch.configs import Config
from deepcharuco_tpu_torch.data import cvnp
from deepcharuco_tpu_torch.data.sources import open_image_source
from deepcharuco_tpu_torch.data.synth import BoardSynthesizer
from deepcharuco_tpu_torch.ops.heatmap import gaussian_heatmap


def create_label(shape_hw: Tuple[int, int], keypoints: np.ndarray,
                 kpt_ids: np.ndarray, is_negative: bool, dust_bin_ids: int,
                 rng: np.random.Generator):
    """(loc, ids) class-index maps, the reference's ``create_label``
    (``data.py:14-51``) with its 50% collision swap."""
    hc, wc = shape_hw[0] // 8, shape_hw[1] // 8
    loc = np.full((hc, wc), 64, np.int32)
    ids = np.full((hc, wc), dust_bin_ids, np.int32)
    if is_negative:
        return loc, ids

    for (kx, ky), idx in zip(keypoints, kpt_ids):
        x = np.clip(int(kx / 8), 0, wc - 1)
        y = np.clip(int(ky / 8), 0, hc - 1)
        if ids[y, x] != dust_bin_ids and rng.random() > 0.5:
            continue  # collision: keep the incumbent half the time
        loc[y, x] = int(kx) % 8 + 8 * (int(ky) % 8)
        ids[y, x] = idx
    return loc, ids


def normalize_image_host(gray: np.ndarray) -> np.ndarray:
    """(g − 128)/255 float32 (the host side of ``ops.image.normalize_gray``)."""
    return (gray.astype(np.float32) - 128.0) / 255.0


class CharucoDataset:
    """Detector training stream (reference ``CharucoDataset``,
    ``data.py:54-101``): dicts of ``image`` (H, W, 1) float32 normalised
    gray and the ``loc``/``ids`` int32 maps. Validation streams are seeded
    with 42. ``use_native`` picks the synthesis route (see
    :class:`BoardSynthesizer`)."""

    def __init__(self, config: Config, labels: Optional[str] = None,
                 images_folder: Optional[str] = None, validation: bool = False,
                 negative_p: float = 0.05, use_native: bool = True):
        self.config = config
        seed = 42 if validation else None
        self.synth = BoardSynthesizer(config, negative_p=negative_p, seed=seed,
                                      use_native=use_native)
        self.rng = np.random.default_rng(seed)
        self.source = open_image_source(labels or config.val_labels if validation
                                        else labels or config.train_labels,
                                        images_folder, use_native=use_native)

    def __len__(self):
        return len(self.source)

    def __getitem__(self, idx: int):
        photo = self.source.get(idx)
        s = self.synth(photo)
        loc, ids = create_label(s.image.shape[:2], s.keypoints, s.kpt_ids,
                                s.is_negative, self.config.n_ids, self.rng)
        return {"image": normalize_image_host(cvnp.bgr2gray(s.image))[..., None],
                "loc": loc, "ids": ids}


# ---------------------------------------------------------------------------
# RefineNet samples
# ---------------------------------------------------------------------------

def _subpix_refine(gray: np.ndarray, point_xy: np.ndarray, region: int):
    """``cv2.cornerSubPix`` with the reference's criteria
    (``model_utils.py:12-16``: 30 iterations, eps 0.1)."""
    return cvnp.corner_sub_pix(gray, point_xy, region, max_iter=30, eps=0.1)


def create_refine_sample(image: np.ndarray, keypoint, up_factor: int,
                         rng: np.random.Generator):
    """One (patch, heatmap, corner) triple, the reference's ``create_sample``
    (``data_refinenet.py:41-91``). ``image``: (H, W, 3) uint8 rendered at
    ``8 // up_factor``× resolution. (None, None, None) where the corner is too
    near the border for a full crop, as the reference skips it."""
    w_half = (192 + 64) // (2 * up_factor)
    cx, cy = int(keypoint[0]), int(keypoint[1])
    patch = image[cy - w_half:cy + w_half, cx - w_half:cx + w_half]
    if patch.shape != (2 * w_half, 2 * w_half, 3):
        return None, None, None

    patch_up = cvnp.resize_cubic(patch, (256, 256))
    gray_up = cvnp.bgr2gray(patch_up)
    center = np.array([128.0, 128.0], np.float32)
    ref = _subpix_refine(gray_up, center, up_factor)
    ref = np.round(ref).astype(int)
    corr_x, corr_y = int(ref[0]) - 128, int(ref[1]) - 128

    tl = 32
    # inclusive bounds: the reference's random.randint(a, b) includes b
    off_x = int(rng.integers(-tl - corr_x, tl - corr_x))   # [−32−c, 31−c]
    off_y = int(rng.integers(-tl - corr_y, tl - corr_y))
    ncx, ncy = int(ref[0]) + off_x, int(ref[1]) + off_y
    crop = patch_up[ncy - 96:ncy + 96, ncx - 96:ncx + 96]
    if crop.shape[:2] != (192, 192):
        return None, None, None
    small = cvnp.resize_area(crop, (24, 24))

    corner_x = -off_x + tl - 1 - corr_x
    corner_y = -off_y + tl - 1 - corr_y
    if not (0 <= corner_x < 64 and 0 <= corner_y < 64):
        return None, None, None
    heat = gaussian_heatmap(corner_x, corner_y, size=64, sigma=2.0)
    return small, heat, (corner_x, corner_y)


class RefineNetDataset:
    """RefineNet patch stream (reference ``RefineDataset``,
    ``data_refinenet.py:94-175``): frames rendered at 2× (480×640), ``total``
    (patch, heatmap) pairs per image, short lists padded by duplication."""

    def __init__(self, config: Config, labels: Optional[str] = None,
                 images_folder: Optional[str] = None, validation: bool = False,
                 total: int = 8, use_native: bool = True):
        self.total = total
        self.s_factor = 2
        big = dataclasses.replace(config, input_size=(config.input_size[0] * self.s_factor,
                                                      config.input_size[1] * self.s_factor))
        self.config = big
        seed = 42 if validation else None
        self.synth = BoardSynthesizer(big, negative_p=0.0, refinenet=True, seed=seed,
                                      use_native=use_native)
        self.rng = np.random.default_rng(seed)
        self.source = open_image_source(labels, images_folder, size_hw=big.input_hw,
                                        use_native=use_native)

    def __len__(self):
        return len(self.source)

    def __getitem__(self, idx: int):
        s = self.synth(self.source.get(idx))
        up_factor = 8 // self.s_factor
        order = self.rng.permutation(len(s.keypoints))
        patches, heatmaps = [], []
        for i in order:
            patch, heat, _ = create_refine_sample(s.image, s.keypoints[i], up_factor, self.rng)
            if patch is None:
                continue
            patches.append(normalize_image_host(cvnp.bgr2gray(patch))[..., None])
            heatmaps.append(heat[..., None])
            if len(patches) == self.total:
                break

        if not patches:  # degenerate frame: every corner at the border
            patches = [np.zeros((24, 24, 1), np.float32)]
            heatmaps = [np.zeros((64, 64, 1), np.float32)]
        while len(patches) < self.total:  # pad by duplication (ref :163-170)
            j = int(self.rng.integers(0, len(patches)))
            patches.append(patches[j])
            heatmaps.append(heatmaps[j])

        return {"patches": np.stack(patches),    # (total, 24, 24, 1)
                "heatmaps": np.stack(heatmaps)}  # (total, 64, 64, 1)

"""Synthetic training samples on the host: an augmented board pasted on a
photo (``deepcharuco_tpu.data.synth``).

The reference pipeline (``src/transformations.py:55-142``,
``custom_aug.py:12-62``): the board rendered once; per sample a random
affine (and coarse dropout) of board, mask and corners; flip, rotate-crop
and crop of the background; the paste through the warped mask; the
photometric stack; with probability ``negative_p`` a background-only
negative. The draws come from an explicit ``np.random.Generator``
(validation streams are seeded with 42, ``data.py:64``), call for call the
JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from deepcharuco_tpu_torch.board import rendered_board
from deepcharuco_tpu_torch.configs import Config
from deepcharuco_tpu_torch.data import augment as A


@dataclasses.dataclass
class SynthSample:
    image: np.ndarray       # (H, W, 3) uint8 BGR composite
    keypoints: np.ndarray   # (M, 2) float32, visible inner corners
    kpt_ids: np.ndarray     # (M,) int corner ids
    is_negative: bool


class BoardSynthesizer:
    """The reference ``Transformation``'s sample stream.

    ``refinenet=True`` narrows the affine ranges and turns dropout and
    negatives off (``transformations.py:23-26``, ``data_refinenet.py:110-111``).
    ``use_native=True`` fuses paste and photometric stack in the native core
    (and raises if it cannot be built); ``False`` runs the numpy stack.
    """

    def __init__(self, config: Config, negative_p: float = 0.05,
                 refinenet: bool = False, seed: Optional[int] = None,
                 use_native: bool = True):
        self.config = config
        self.negative_p = 0.0 if refinenet else negative_p
        self.refinenet = refinenet
        self.rng = np.random.default_rng(seed)
        self.input_hw = config.input_hw  # (H, W)
        self._native = None
        if use_native:
            from deepcharuco_tpu_torch.data import native

            native.load()
            self._native = native

        # the board rendered once (cv2's generateImage, from the asset)
        min_r = min(config.input_size)
        gray, corners = rendered_board(config, min_r)
        self.board_img = np.repeat(gray[..., None], 3, axis=-1)
        self.corners = corners.astype(np.int64)
        self.ids = np.arange(self.corners.shape[0])
        self.board_mask = np.full(self.board_img.shape[:2], 255, np.uint8)

        if refinenet:
            self.affine_kw = dict(scale_range=(0.3, 0.75), translate_frac=(0.0, 0.0))
            self.dropout_p = 0.0
        else:
            self.affine_kw = dict(scale_range=(0.25, 0.9), translate_frac=(-0.45, 0.45))
            self.dropout_p = 0.4

    def _augment_board(self):
        """Pad the board to the frame, random affine, optional dropout:
        (board_bgr, mask, keypoints, kp_visible)."""
        hw = self.input_hw
        img, kpts = A.pad_to_size(self.board_img, hw, self.corners.astype(np.float64))
        mask, _ = A.pad_to_size(self.board_mask, hw)

        M = A.affine_matrix(self.rng, hw, rotate_deg=(-360, 360),
                            shear_deg=(-35, 35), **self.affine_kw)
        img = A.warp_affine(img, M, hw)
        mask = A.warp_affine(mask, M, hw, nearest=True)
        kpts = A.transform_keypoints(kpts, M)
        visible = A.keypoints_in_bounds(kpts, hw)

        if self.dropout_p > 0 and self.rng.random() < self.dropout_p:
            img, mask, visible = A.coarse_dropout(self.rng, img, mask, kpts, visible)
        return img, mask, kpts, visible

    def _augment_background(self, photo: np.ndarray) -> np.ndarray:
        """Flip, rotate-crop, pad and random crop to the frame
        (``transformations.py:90-99``)."""
        photo = A.random_flip(self.rng, photo)
        return A.random_rotate_crop_then_crop(self.rng, photo, self.input_hw)

    def __call__(self, photo: np.ndarray) -> SynthSample:
        return self.synthesize(photo)

    def synthesize(self, photo: np.ndarray) -> SynthSample:
        board, mask, kpts, visible = self._augment_board()
        bg = self._augment_background(photo)

        is_negative = bool(self.rng.random() < self.negative_p)
        if is_negative:
            kpts_out = np.zeros((0, 2), np.float32)
            ids_out = np.zeros((0,), np.int64)
        else:
            kpts_out = kpts[visible].astype(np.float32)
            ids_out = self.ids[visible]

        if self._native is not None:
            # paste + photometric fused in one native pass; the blur radius
            # drawn at about the numpy stack's Gaussian + motion blur rate
            blur = int(self.rng.integers(1, 3)) if self.rng.random() < 0.6 else 0
            composite = self._native.composite_photometric(
                int(self.rng.integers(0, 2**63)), board, mask, bg,
                is_negative=is_negative, blur_radius=blur)
        else:
            if is_negative:
                composite = bg
            else:
                composite = bg.copy()
                m = mask.astype(bool)
                composite[m] = board[m]
            composite = A.photometric_pipeline(self.rng, composite)
        return SynthSample(image=composite, keypoints=kpts_out,
                           kpt_ids=ids_out, is_negative=is_negative)

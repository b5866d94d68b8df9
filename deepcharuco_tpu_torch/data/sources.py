"""Background images for the host synthesis (``deepcharuco_tpu.data.sources``).

The reference indexes COCO through a captions json's ``images`` list and
reads each file with cv2 (``src/data.py:60-69``). That format and a plain
directory are read here too; ``.png`` files go through the port's own
decoder (:mod:`~deepcharuco_tpu_torch.data.png`, equal to cv2's read), other
photo formats through cv2 where it can be imported (without cv2 their read
raises ``SystemExit`` naming it). The procedural source needs no files and no cv2:
it runs on the native core by default, or on numpy and
:mod:`~deepcharuco_tpu_torch.data.cvnp` with ``use_native=False``.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from deepcharuco_tpu_torch.data import cvnp


def _imread(path: str) -> np.ndarray:
    from deepcharuco_tpu_torch.cli import imread

    img = imread(path)
    if img is None:
        raise IOError(f"unreadable image: {path}")
    return img


class DirectoryImageSource:
    """All images under a directory, sorted."""

    EXTS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(self, path: str):
        self.paths: List[str] = sorted(
            os.path.join(path, f) for f in os.listdir(path) if f.lower().endswith(self.EXTS))
        if not self.paths:
            raise ValueError(f"no images found under {path}")

    def __len__(self):
        return len(self.paths)

    def get(self, idx: int) -> np.ndarray:
        return _imread(self.paths[idx % len(self.paths)])


class CocoJsonImageSource:
    """COCO captions json + images folder (``labels['images'][i]['file_name']``,
    the reference's format, ``data.py:60-69``)."""

    def __init__(self, labels_json: str, images_folder: str):
        with open(labels_json) as f:
            self.entries = json.load(f)["images"]
        self.folder = images_folder

    def __len__(self):
        return len(self.entries)

    def get(self, idx: int) -> np.ndarray:
        name = self.entries[idx % len(self.entries)]["file_name"]
        return _imread(os.path.join(self.folder, name))


class ProceduralImageSource:
    """Random textured BGR backgrounds (gradient, soft blobs, noise); the
    index is the seed. ``use_native=True`` runs the native core (and raises
    if it cannot be built); ``False`` the numpy route, a different stream."""

    def __init__(self, size_hw=(480, 640), n_virtual: int = 10000,
                 use_native: bool = True):
        self.size_hw = size_hw
        self.n = n_virtual
        self._native = None
        if use_native:
            from deepcharuco_tpu_torch.data import native

            native.load()
            self._native = native

    def __len__(self):
        return self.n

    def get(self, idx: int) -> np.ndarray:
        if self._native is not None:
            return self._native.procedural_bg(idx, *self.size_hw)
        return self._get_numpy(idx)

    def _get_numpy(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(idx)
        h, w = self.size_hw
        # smooth colour gradient base
        corners = rng.uniform(0, 255, (2, 2, 3)).astype(np.float32)
        img = cvnp.resize_linear_f32(corners, (h, w))
        # random soft blobs
        for _ in range(int(rng.integers(2, 8))):
            cx, cy = rng.integers(0, w), rng.integers(0, h)
            r = int(rng.integers(h // 8, h // 2))
            color = rng.uniform(0, 255, 3)
            overlay = img.copy()
            cvnp.circle_filled(overlay, (int(cx), int(cy)), r, color.tolist())
            alpha = rng.uniform(0.2, 0.7)
            img = img * (1 - alpha) + overlay * alpha
        # broadband noise
        img = img + rng.normal(0, rng.uniform(2, 12), img.shape)
        return np.clip(img, 0, 255).astype(np.uint8)


def open_image_source(labels: Optional[str] = None,
                      images_folder: Optional[str] = None,
                      size_hw=(480, 640), use_native: bool = True):
    """COCO json + folder, else a directory, else procedural (the JAX
    package's order)."""
    if labels and images_folder and os.path.exists(labels):
        return CocoJsonImageSource(labels, images_folder)
    if images_folder and os.path.isdir(images_folder):
        return DirectoryImageSource(images_folder)
    return ProceduralImageSource(size_hw=size_hw, use_native=use_native)

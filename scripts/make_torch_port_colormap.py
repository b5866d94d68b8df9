"""Write deepcharuco_tpu_torch/assets/viridis.npz: cv2's viridis colour map
as a 256-entry BGR table, for the port's viewer, which has no cv2 on the
card's machine (``cvnp.apply_colormap`` looks it up).

Stored under ``bgr``: ``applyColorMap(arange(256), COLORMAP_VIRIDIS)``,
(256, 3) uint8 BGR, the map ``cli.view --what refine`` draws with.

Run from the repository root: ``python scripts/make_torch_port_colormap.py``.
"""

from __future__ import annotations

import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "deepcharuco_tpu_torch", "assets", "viridis.npz")


def main():
    import cv2

    ramp = np.arange(256, dtype=np.uint8).reshape(1, 256)
    np.savez_compressed(OUT, bgr=cv2.applyColorMap(ramp, cv2.COLORMAP_VIRIDIS)[0])
    print(OUT, os.path.getsize(OUT), "bytes, cv2", cv2.__version__)


if __name__ == "__main__":
    main()

"""Write deepcharuco_tpu_torch/assets/board_renders.npz: the default board
rendered by the JAX package (cv2's ChArUco renderer), for the port's
on-card synthesis where cv2 is absent.

Stored per render, under the key prefix of
``deepcharuco_tpu_torch.board.render_key``: ``<prefix>/image`` the uint8
gray render (size × size, channel 0 of ``deepcharuco_tpu.board.board_image``)
and ``<prefix>/corners`` its inner-corner pixels ((n_ids, 2) int32, x, y).
Sizes: 240 (the detector synthesiser's ``min(input_size)``), 480 and 960 (the
RefineNet synthesiser and ``--frame-scale 2`` render at 2×, ``--frame-scale 4`` at 4×),
and 64 and 128 for the tests' small 64×96 frames.

Run from the repository root: ``python scripts/make_torch_port_board.py``.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from deepcharuco_tpu import board as B  # noqa: E402
from deepcharuco_tpu.configs import default_config  # noqa: E402
from deepcharuco_tpu_torch.board import ASSET, render_key  # noqa: E402

SIZES = (64, 128, 240, 480, 960)


def main():
    cfg = default_config()
    out = {}
    for size in SIZES:
        img, corners = B.board_image(B.get_board(cfg), (size, size), cfg.row_count,
                                     cfg.col_count)
        key = render_key(cfg, size)
        out[f"{key}/image"] = np.ascontiguousarray(img[..., 0]).astype(np.uint8)
        out[f"{key}/corners"] = corners.astype(np.int32)
    os.makedirs(os.path.dirname(ASSET), exist_ok=True)
    np.savez_compressed(ASSET, **out)
    print(ASSET, os.path.getsize(ASSET), "bytes:", sorted(out))


if __name__ == "__main__":
    main()

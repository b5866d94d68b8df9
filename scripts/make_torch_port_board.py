"""Write deepcharuco_tpu_torch/assets/board_renders.npz: the default board
rendered by the JAX package (cv2's ChArUco renderer) and the ArUco
dictionaries' bits, for the port, which has no cv2 on the card's machine.

Stored per render, under the key prefix of
``deepcharuco_tpu_torch.board.render_key``: ``<prefix>/image`` the uint8
gray render (size × size, channel 0 of ``deepcharuco_tpu.board.board_image``)
and ``<prefix>/corners`` its inner-corner pixels ((n_ids, 2) int32, x, y).
Sizes: 240 (the detector synthesiser's ``min(input_size)``), 480 and 960 (the
RefineNet synthesiser and ``--frame-scale 2`` render at 2×, ``--frame-scale 4`` at 4×),
and 64 and 128 for the tests' small 64×96 frames. Every other board and
size is drawn by ``deepcharuco_tpu_torch.board.render_charuco``.

Stored per dictionary, ``aruco/<name>``: every marker's inner bits,
(n_markers, bits, bits) bool, channel 0 of ``generateImageMarker(id,
bits + 2)`` without its border. The ``_50``/``_100``/``_250`` dictionaries
are the first markers of the ``_1000`` one of the same bit size (checked
here) and are not stored twice. ``--dicts`` names the dictionaries (default:
all of cv2's predefined ones); names are stored in upper case.

Run from the repository root: ``python scripts/make_torch_port_board.py``.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from deepcharuco_tpu import board as B  # noqa: E402
from deepcharuco_tpu.configs import default_config  # noqa: E402
from deepcharuco_tpu_torch.board import _PREFIX_OF, ASSET, render_key  # noqa: E402

SIZES = (64, 128, 240, 480, 960)


def dictionary_bits(name: str) -> np.ndarray:
    d = B.get_aruco_dict(name)
    n = d.markerSize
    return np.stack([d.generateImageMarker(i, n + 2)[1:-1, 1:-1] > 127
                     for i in range(d.bytesList.shape[0])])


def predefined() -> list:
    import cv2

    # cv2 spells some names twice (…_36h11 and …_36H11): one, upper case
    return sorted({n.upper() for n in dir(cv2.aruco) if n.startswith("DICT_")})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dicts", nargs="*", default=None,
                   help="dictionary names to store (default: all predefined)")
    args = p.parse_args(argv)
    cfg = default_config()
    out = {}
    for size in SIZES:
        img, corners = B.board_image(B.get_board(cfg), (size, size), cfg.row_count,
                                     cfg.col_count)
        key = render_key(cfg, size)
        out[f"{key}/image"] = np.ascontiguousarray(img[..., 0]).astype(np.uint8)
        out[f"{key}/corners"] = corners.astype(np.int32)
    for name in args.dicts or predefined():
        name = name.upper()
        stored = _PREFIX_OF.get(name, name)
        bits = dictionary_bits(stored)
        if stored != name:
            assert (dictionary_bits(name) == bits[:int(name.rsplit("_", 1)[1])]).all(), name
        out[f"aruco/{stored}"] = bits
    os.makedirs(os.path.dirname(ASSET), exist_ok=True)
    np.savez_compressed(ASSET, **out)
    print(ASSET, os.path.getsize(ASSET), "bytes:", sorted(out))


if __name__ == "__main__":
    main()

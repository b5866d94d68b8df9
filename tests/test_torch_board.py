"""The port's board renders against the JAX package's (cv2's ChArUco
renderer), fault C2: the renders existed only for the default board at
five sizes, so any other board, and ``--frame-scale 3``, raised
``KeyError``. Now ``render_charuco`` draws any board at any size in numpy
from the ArUco bits in the asset; it must equal cv2's render pixel for
pixel, and so must the corner pixels."""

import functools
import json
import os

import numpy as np
import pytest

from deepcharuco_tpu import board as JB
from deepcharuco_tpu.configs import Config
from deepcharuco_tpu_torch import board as B
from deepcharuco_tpu_torch.configs import default_config
from deepcharuco_tpu_torch.configs import Config as PConfig

FOUR_BY_THREE = dict(board_name="DICT_4X4_50", row_count=3, col_count=4, square_len=0.02,
                     marker_len=0.015, input_size=(256, 192))
FIVE_BIT = dict(board_name="DICT_5X5_100", row_count=6, col_count=6, square_len=0.04,
                marker_len=0.03, input_size=(320, 240))
CASES = ([("default", size) for size in (64, 96, 240, 480, 720, 960)]
         + [("4x3", 192), ("5x5 bits", 192), ("5x5 bits", 240)])


def configs(name):
    kw = {"default": dict(default_config().__dict__), "4x3": FOUR_BY_THREE,
          "5x5 bits": FIVE_BIT}[name]
    kw = {k: kw[k] for k in ("board_name", "row_count", "col_count", "square_len",
                             "marker_len", "input_size")}
    return Config(**kw), PConfig(**kw)


@pytest.mark.parametrize("name,size", CASES)
def test_numpy_render_equals_cv2(name, size):
    jcfg, pcfg = configs(name)
    img, corners = JB.board_image(JB.get_board(jcfg), (size, size), jcfg.row_count,
                                  jcfg.col_count)
    np.testing.assert_array_equal(B.render_charuco(pcfg, size), img[..., 0])
    gray, got_corners = B.rendered_board(pcfg, size)
    np.testing.assert_array_equal(gray, img[..., 0])
    np.testing.assert_array_equal(got_corners, corners)
    assert got_corners.dtype == np.int32 and gray.dtype == np.uint8


def test_default_board_equals_cv2_at_every_size():
    jcfg, pcfg = configs("default")
    bits = B.aruco_bits(pcfg.board_name)
    for size in range(40, 1001, 29):
        ref = JB.board_image(JB.get_board(jcfg), (size, size), 5, 5)[0][..., 0]
        np.testing.assert_array_equal(B.render_charuco(pcfg, size, bits), ref,
                                      err_msg=str(size))


def test_stored_renders_are_still_read():
    cfg = default_config()
    with np.load(B.ASSET) as z:
        for size in (64, 128, 240, 480, 960):
            key = B.render_key(cfg, size)
            gray, corners = B.rendered_board(cfg, size)
            np.testing.assert_array_equal(gray, z[f"{key}/image"])
            np.testing.assert_array_equal(corners, z[f"{key}/corners"])


@pytest.mark.parametrize("name", ["DICT_4X4_50", "DICT_5X5_250", "DICT_6X6_1000",
                                  "DICT_ARUCO_ORIGINAL", "DICT_APRILTAG_36h11"])
def test_dictionary_bits_equal_cv2(name):
    d = JB.get_aruco_dict(name)
    n = d.markerSize
    want = np.stack([d.generateImageMarker(i, n + 2)[1:-1, 1:-1] > 127
                     for i in range(d.bytesList.shape[0])])
    np.testing.assert_array_equal(B.aruco_bits(name), want)


def test_unknown_dictionary_names_the_script():
    with pytest.raises(KeyError, match="make_torch_port_board.py"):
        B.aruco_bits("DICT_NOT_THERE")


def test_frame_scale_3_trains_on_64x96_frames(tmp_path, monkeypatch):
    """``cli.train_refinenet --frame-patches --frame-scale 3`` needs a 192 px
    render of the board, which the asset does not store."""
    from deepcharuco_tpu_torch.cli import train_refinenet as rn_cli
    from deepcharuco_tpu_torch.train import logging as train_logging

    monkeypatch.setattr(train_logging, "ScalarLogger",
                        functools.partial(train_logging.ScalarLogger, use_tensorboard=False))
    cfg = tmp_path / "small.yaml"
    cfg.write_text("board_name: DICT_4X4_50\nrow_count: 5\ncol_count: 5\nsquare_len: 0.01\n"
                   "marker_len: 0.0075\ninput_size: [96, 64]\nbs_val: 4\nbs_val_rn: 8\n")
    with np.load(B.ASSET) as z:
        assert f"{B.render_key(default_config(), 192)}/image" not in z.files
    logdir = str(tmp_path / "tb")
    rn_cli.main(["--config", str(cfg), "--device", "cpu", "--device-synth", "--frame-patches",
                 "--frame-scale", "3", "--batch-size", "8", "--steps", "1", "--eval-every",
                 "1", "--eval-batches", "1", "--logdir", logdir,
                 "--ckpt-dir", str(tmp_path / "ck")])
    with open(os.path.join(logdir, "scalars.jsonl")) as f:
        (row,) = [json.loads(line) for line in f]
    assert np.isfinite(row["train_refinenet_loss"]) and np.isfinite(row["val_refinenet_loss"])

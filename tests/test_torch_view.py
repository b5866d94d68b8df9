"""The port's grid viewer (``deepcharuco_tpu_torch.cli.view``) and the cv2
calls it restates (``data/cvnp.py``: ``circle`` one pixel wide,
``resize`` INTER_NEAREST and INTER_LINEAR on uint8, ``applyColorMap``
viridis), against cv2 5.0.0 and the JAX package's ``cli.view`` on the CPU.

Tolerances: the cvnp calls are bit-equal; the ``dataset`` and ``refine``
pages pixel-equal to the JAX CLI's on the same seeded stream; the
``predictions`` page is what the port draws from its own ``detect``, whose
corners are held to the JAX package's ``detect`` within phase 4's limits
of ``chip_smoke.py`` (≤ 2% slot and coordinate mismatch, |Δrefined| ≤ 0.125
px on ≥ 98% of the agreeing slots).
"""

import os
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from deepcharuco_tpu.cli import view as jax_view  # noqa: E402
from deepcharuco_tpu_torch import board as B  # noqa: E402
from deepcharuco_tpu_torch.cli import view  # noqa: E402
from deepcharuco_tpu_torch.data import cvnp, png  # noqa: E402

N = 4
CPU = ["--device", "cpu"]


# --- the cvnp additions --------------------------------------------------

@pytest.mark.parametrize("radius", range(1, 9))
def test_circle_is_bit_equal(radius):
    rng = np.random.default_rng(radius)
    for center in [(0, 0), (5, 5), (30, 20), (-3, 10), (63, 47), (66, 50), (10, -2),
                   (62, 1), (-20, -20)]:
        for shape in [(48, 64, 3), (48, 64)]:
            a = rng.integers(0, 256, shape, dtype=np.uint8)
            b = a.copy()
            cv2.circle(a, center, radius, (255, 0, 255), thickness=1)
            cvnp.circle(b, center, radius, (255, 0, 255))
            np.testing.assert_array_equal(a, b, err_msg=f"{center} {shape}")


@pytest.mark.parametrize("src,dst", [((24, 24), (64, 64)), ((32, 32), (64, 64)),
                                     ((13, 17), (40, 33)), ((240, 320), (100, 130)),
                                     ((10, 10), (3, 7))])
def test_resize_nearest_is_bit_equal(src, dst):
    img = np.random.default_rng(0).integers(0, 256, src + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(cvnp.resize_nearest(img, dst),
                                  cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST))


# ``view --images`` resizes any frame to 240×320; the others are ragged rows
# (the tail of a row takes the same rounding)
@pytest.mark.parametrize("src,dst", [((480, 640), (240, 320)), ((300, 400), (240, 320)),
                                     ((720, 1280), (240, 320)), ((200, 300), (240, 320)),
                                     ((243, 322), (240, 320)), ((100, 100), (240, 320)),
                                     ((13, 17), (5, 7)), ((50, 60), (31, 48))])
def test_resize_linear_u8_is_bit_equal(src, dst):
    rng = np.random.default_rng(src[0])
    for img in (rng.integers(0, 256, src, dtype=np.uint8),
                rng.integers(0, 256, src + (3,), dtype=np.uint8)):
        np.testing.assert_array_equal(cvnp.resize_linear_u8(img, dst),
                                      cv2.resize(img, dst[::-1]))


def test_apply_colormap_is_bit_equal():
    gray = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(cvnp.apply_colormap(gray, "viridis"),
                                  cv2.applyColorMap(gray, cv2.COLORMAP_VIRIDIS))
    with pytest.raises(KeyError, match="only viridis"):
        cvnp.apply_colormap(gray, "jet")


def test_draw_inner_corners_equals_cv2_and_needs_it_only_for_labels(monkeypatch):
    from deepcharuco_tpu import board as JB

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
    corners = rng.uniform(-4, 84, (20, 2))
    np.testing.assert_array_equal(B.draw_inner_corners(img, corners, np.arange(20)),
                                  JB.draw_inner_corners(img, corners, np.arange(20)))
    monkeypatch.setitem(sys.modules, "cv2", None)
    B.draw_inner_corners(img, corners, np.arange(20), radius=3)
    with pytest.raises(ImportError):
        B.draw_inner_corners(img, corners, np.arange(20), draw_ids=True)


# --- the CLI against the JAX package's ----------------------------------

@pytest.fixture(scope="module")
def pages(tmp_path_factory):
    """Both CLIs' first page in each mode (the port's with cv2 made
    unimportable), on the seeded validation stream."""
    d = tmp_path_factory.mktemp("view")
    out = {}
    for what in ("dataset", "refine", "predictions"):
        flags = ["--what", what, "--n", str(N), "--validation"]
        jax_view.main(flags + ["--out", str(d / f"jax_{what}")])
        saved = sys.modules.get("cv2")
        sys.modules["cv2"] = None
        try:
            paths = view.main(flags + ["--out", str(d / f"port_{what}")] + CPU)
        finally:
            sys.modules["cv2"] = saved
        out[what] = (png.read_png(paths[0]), cv2.imread(str(d / f"jax_{what}_p0.png")))
    return out


@pytest.mark.parametrize("what", ["dataset", "refine"])
def test_training_stream_pages_equal_the_jax_cli(pages, what):
    got, want = pages[what]
    np.testing.assert_array_equal(got, want)


def test_predictions_page_draws_detect_within_phase_4_of_jax(pages):
    """The page is the port's drawing of its own ``detect`` on the
    validation frames; those corners are within phase 4's limits of the JAX
    package's ``detect`` on the same frames."""
    from deepcharuco_tpu.pipeline import load_pipeline as jax_load
    from deepcharuco_tpu_torch.configs import default_config
    from deepcharuco_tpu_torch.data import CharucoDataset
    from deepcharuco_tpu_torch.pipeline import load_pipeline

    cfg = default_config()
    ds = CharucoDataset(cfg, validation=True)
    samples = [ds[i] for i in range(N)]
    frames = np.stack([view._denorm(s["image"]) for s in samples])
    pipe = load_pipeline(cfg, "artifacts/detector_devsynth.npz",
                         "artifacts/refinenet_devsynth.npz", device="cpu")
    kp, valid, refined = pipe.detect(frames)
    cells = []
    for img, s, v, r in zip(frames, samples, valid, refined):
        truth = view._truth(s, cfg.n_ids)
        img = B.draw_keypoints_with_validity(img, truth[0], truth[1], color=(0, 255, 0))
        cells.append(B.draw_keypoints_with_validity(img, r, v, color=(255, 0, 255)))
    np.testing.assert_array_equal(pages["predictions"][0], view._tile(cells, 4))

    from deepcharuco_tpu.configs import default_config as jax_config
    jpipe = jax_load(jax_config(), "artifacts/detector_devsynth.npz",
                     "artifacts/refinenet_devsynth.npz")
    jkp, jvalid, jref = (np.asarray(a) for a in jpipe.detect(frames))
    assert (valid != jvalid).mean() <= 0.02
    both = valid & jvalid
    assert (np.abs(kp - jkp).max(-1)[both] > 0).mean() <= 0.02
    assert (np.abs(refined - jref).max(-1)[both] <= 0.125).mean() >= 0.98


def test_predictions_on_png_images_without_cv2(tmp_path, monkeypatch):
    """``--images``: a directory of PNGs of another size, resized to the
    input by ``cvnp.resize_linear_u8`` (the JAX CLI's ``cv2.resize``)."""
    rng = np.random.default_rng(2)
    d = tmp_path / "imgs"
    d.mkdir()
    frames = rng.integers(0, 256, (2, 300, 400, 3), dtype=np.uint8)
    for i, f in enumerate(frames):
        png.write_png(d / f"f{i}.png", f)
    monkeypatch.setitem(sys.modules, "cv2", None)
    paths = view.main(["--what", "predictions", "--images", str(d), "--n", "2", "--cols", "2",
                       "--out", str(tmp_path / "p")] + CPU)
    page = png.read_png(paths[0])
    assert page.shape == (2 + 242, 2 + 2 * 322, 3)
    first = cvnp.resize_linear_u8(frames[0], (240, 320))
    # pixels away from the drawn circles are the resized frame
    untouched = (page[2:242, 2:322] == first).all(-1).mean()
    assert untouched > 0.99


def test_show_without_display_is_ignored_and_with_one_needs_cv2(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("DISPLAY", raising=False)
    view.main(["--what", "dataset", "--n", "1", "--validation", "--show",
               "--out", str(tmp_path / "a")] + CPU)
    assert "--show ignored" in capsys.readouterr().out
    monkeypatch.setenv("DISPLAY", ":99")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(SystemExit, match="--show needs OpenCV"):
        view.main(["--what", "dataset", "--n", "1", "--validation", "--show",
                   "--out", str(tmp_path / "b")] + CPU)


def test_without_a_card_the_viewer_refuses_the_cpu_unasked(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        view.main(["--what", "dataset", "--n", "1", "--out", str(tmp_path / "a")])
    assert not os.path.exists(tmp_path / "a_p0.png")

"""The port's host data pipeline against cv2 5.0.0 and the JAX package.

``deepcharuco_tpu_torch.data.cvnp`` restates every cv2 call of the JAX
package's host pipeline in numpy; each function is held here to cv2 at the
pipeline's own sizes (bit-equal where OpenCV's arithmetic is restated, the
stated bound where it is not). Then the pipeline's pieces and the whole
(``BoardSynthesizer`` on both routes, both datasets, the background bank) run
beside the JAX package's with the same seeds: labels equal, images within
the route's bar. The batcher and the copy to the device run on the CPU, and
a subprocess with cv2 blocked runs the procedural pipeline end to end.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from deepcharuco_tpu.configs import default_config as jax_default_config
from deepcharuco_tpu.data import augment as jaug
from deepcharuco_tpu_torch.configs import default_config
from deepcharuco_tpu_torch.data import augment as aug
from deepcharuco_tpu_torch.data import cvnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# cv2's IPP route for uint8 INTER_CUBIC differs from OpenCV's own code (which
# cvnp restates) by one level on this share of values at most (measured on
# 40 board and noise patches 64² → 256²: 14 of 7,864,320 values; PERF.md §6)
CUBIC_IPP_SHARE = 2e-6


def diff(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="module")
def frames():
    """A noise frame and a board frame at each pipeline size."""
    r = np.random.default_rng(1)
    out = {}
    for h, w in ((240, 320), (480, 640)):
        noise = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
        board = cv2.cvtColor(jax_board(min(h, w)), cv2.COLOR_GRAY2BGR)
        frame, _ = jaug.pad_to_size(board, (h, w))
        out[(h, w)] = (noise, frame)
    return out


def jax_board(size):
    from deepcharuco_tpu import board as B

    cfg = jax_default_config()
    img, _ = B.board_image(B.get_board(cfg), (size, size), cfg.row_count, cfg.col_count)
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)


# --- colour ---------------------------------------------------------------

def all_colours(width):
    axes = np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij")
    return np.stack(axes, -1).reshape(-1, width, 3).astype(np.uint8)


def test_bgr2gray_is_bit_equal_on_every_colour():
    img = all_colours(256)
    np.testing.assert_array_equal(cvnp.bgr2gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


def test_bgr2hsv_is_bit_equal_on_every_colour():
    img = all_colours(256)
    np.testing.assert_array_equal(cvnp.bgr2hsv(img), cv2.cvtColor(img, cv2.COLOR_BGR2HSV))


@pytest.mark.parametrize("width", [320, 640, 37, 1])
def test_hsv2bgr_is_bit_equal_in_rows_of_any_width(width):
    """cv2's vector loop truncates, its scalar tail rounds: both restated."""
    axes = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack(axes, -1).reshape(-1, 3).astype(np.uint8)
    if width != 320:        # every input at the detector's width, a sample at the others
        hsv = hsv[np.random.default_rng(width).permutation(len(hsv))[:640 * 1000]]
    hsv = hsv[: len(hsv) // width * width].reshape(-1, width, 3)
    np.testing.assert_array_equal(cvnp.hsv2bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


# --- geometry ---------------------------------------------------------------

@pytest.mark.parametrize("code", [-1, 0, 1])
def test_flip_is_bit_equal(frames, code):
    img = frames[(240, 320)][0]
    np.testing.assert_array_equal(cvnp.flip(img, code), cv2.flip(img, code))


def test_rotation_matrix_within_1e_12(rng):
    for ang in list(rng.uniform(-180, 180, 20)) + [0.0, 90.0, -180.0]:
        for center in ((160, 120), (320.0, 240.0), (37.5, 11.25)):
            got = cvnp.rotation_matrix_2d(center, ang, 1.0)
            assert diff(got, cv2.getRotationMatrix2D(center, ang, 1.0)).max() <= 1e-12


@pytest.mark.parametrize("hw", [(240, 320), (480, 640)])
def test_warp_affine_is_bit_equal(frames, hw):
    """The board warps (linear, 3 channels; nearest, the mask) and the
    background rotation at both frame sizes, on noise and on a board."""
    r = np.random.default_rng(hw[0])
    for img in frames[hw]:
        for _ in range(4):
            M = jaug.affine_matrix(r, hw)
            for src, nearest in ((img, False), (img[..., 1].copy(), False),
                                 (img[..., 0].copy(), True), (img, True)):
                want = cv2.warpAffine(src, M, (hw[1], hw[0]),
                                      flags=cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR,
                                      borderMode=cv2.BORDER_CONSTANT, borderValue=0)
                np.testing.assert_array_equal(cvnp.warp_affine(src, M, hw, nearest), want)
        R = cv2.getRotationMatrix2D((hw[1] / 2, hw[0] / 2), float(r.uniform(-180, 180)), 1.0)
        want = cv2.warpAffine(img, R, (hw[1], hw[0]), flags=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(cvnp.warp_affine(img, R, hw), want)
        window = (17, hw[0] - 30, 41, hw[1] - 3)
        np.testing.assert_array_equal(cvnp.warp_affine(img, R, hw, window=window),
                                      want[17:hw[0] - 30, 41:hw[1] - 3])


def test_rotate_crop_and_crop_consume_the_generator_like_jax(frames):
    photo = frames[(480, 640)][0]
    for seed in range(12):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jaug.random_crop(a, jaug.random_rotate_crop(a, photo), (240, 320))
        np.testing.assert_array_equal(aug.random_rotate_crop_then_crop(b, photo, (240, 320)),
                                      want)
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(aug.random_rotate_crop(b, photo),
                                      jaug.random_rotate_crop(a, photo))
        assert a.random() == b.random()


# --- resizing, filters, sub-pixel corners ------------------------------------

def refine_patches(n=20):
    """64×64 BGR patches around board corners at the RefineNet render size,
    and noise patches."""
    r = np.random.default_rng(3)
    frame = cv2.cvtColor(jax_board(480), cv2.COLOR_GRAY2BGR)
    out = []
    for _ in range(n):
        M = jaug.affine_matrix(r, (480, 480), scale_range=(0.6, 1.0), translate_frac=(0, 0))
        img = cv2.warpAffine(frame, M, (480, 480))
        cx, cy = (M @ np.array([480 * 2 / 5, 480 * 2 / 5, 1.0])).astype(int)
        out.append(img[cy - 32:cy + 32, cx - 32:cx + 32])
        out.append(r.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    return [p for p in out if p.shape == (64, 64, 3)]


def test_resize_cubic_is_bit_equal_to_opencv_and_near_ipp():
    patches = refine_patches()
    ipp_diff = total = 0
    for p in patches:
        got = cvnp.resize_cubic(p, (256, 256))
        with_ipp = cv2.resize(p, (256, 256), interpolation=cv2.INTER_CUBIC)
        cv2.ipp.setUseIPP(False)
        try:
            plain = cv2.resize(p, (256, 256), interpolation=cv2.INTER_CUBIC)
        finally:
            cv2.ipp.setUseIPP(True)
        np.testing.assert_array_equal(got, plain)
        d = diff(got, with_ipp)
        assert d.max() <= 1
        ipp_diff += int((d > 0).sum())
        total += d.size
    assert ipp_diff / total <= CUBIC_IPP_SHARE, ipp_diff / total


def test_resize_area_bit_equal_at_factor_8_and_near_elsewhere(rng):
    for _ in range(10):
        crop = rng.integers(0, 256, (192, 192, 3), dtype=np.uint8)
        np.testing.assert_array_equal(cvnp.resize_area(crop, (24, 24)),
                                      cv2.resize(crop, (24, 24), interpolation=cv2.INTER_AREA))
    for shape in ((960, 1280), (1000, 1333), (500, 700), (300, 500), (400, 900)):
        gray = rng.integers(0, 256, shape, dtype=np.uint8)
        d = diff(cvnp.resize_area(gray, (480, 640)),
                 cv2.resize(gray, (640, 480), interpolation=cv2.INTER_AREA))
        assert d.max() <= 1, shape


@pytest.mark.parametrize("k", [3, 5, 7])
def test_gaussian_blur_is_bit_equal(frames, k):
    for img in frames[(240, 320)]:
        np.testing.assert_array_equal(cvnp.gaussian_blur(img, k),
                                      cv2.GaussianBlur(img, (k, k), 0))


def test_filter2d_within_one_level_on_one_percent(frames):
    """The motion-blur kernels the photometric stack draws."""
    for seed in range(8):
        img = frames[(240, 320)][seed % 2]
        r = np.random.default_rng(seed)
        k = (3, 5)[seed % 2]
        kernel = np.zeros((k, k), np.float32)
        ang = r.uniform(0, np.pi)
        for i in range(k):
            t = i - (k - 1) / 2
            kernel[int(np.clip(round((k - 1) / 2 + t * np.sin(ang)), 0, k - 1)),
                   int(np.clip(round((k - 1) / 2 + t * np.cos(ang)), 0, k - 1))] = 1.0
        kernel /= kernel.sum()
        d = diff(cvnp.filter2d(img, kernel), cv2.filter2D(img, -1, kernel))
        assert d.max() <= 1 and (d > 0).mean() <= 0.01


def test_resize_linear_float_within_1e_4(rng):
    for _ in range(10):
        corners = rng.uniform(0, 255, (2, 2, 3)).astype(np.float32)
        d = diff(cvnp.resize_linear_f32(corners, (480, 640)),
                 cv2.resize(corners, (640, 480), interpolation=cv2.INTER_LINEAR))
        assert d.max() <= 1e-4


def test_filled_circle_is_bit_equal(rng):
    for _ in range(20):
        a = rng.uniform(0, 255, (480, 640, 3))
        b = a.copy()
        center = (int(rng.integers(-50, 690)), int(rng.integers(-50, 530)))
        radius = int(rng.integers(1, 240))
        color = rng.uniform(0, 255, 3).tolist()
        cvnp.circle_filled(a, center, radius, color)
        cv2.circle(b, center, radius, color, -1)
        np.testing.assert_array_equal(a, b)


def test_corner_sub_pix_within_1e_3_px_and_equal_rounded():
    term = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_COUNT, 30, 0.1)
    for p in refine_patches():
        gray = cv2.cvtColor(cv2.resize(p, (256, 256), interpolation=cv2.INTER_CUBIC),
                            cv2.COLOR_BGR2GRAY)
        for start in ((128.0, 128.0), (126.3, 130.8)):
            want = cv2.cornerSubPix(gray, np.array([[start]], np.float32), (4, 4), (-1, -1),
                                    term).reshape(2)
            got = cvnp.corner_sub_pix(gray, start, 4)
            assert diff(got, want).max() <= 1e-3, (got, want)
            np.testing.assert_array_equal(np.round(got), np.round(want))


# --- labels -----------------------------------------------------------------

def test_gaussian_heatmap_equals_jax():
    from deepcharuco_tpu.ops.heatmap import gaussian_heatmap as jax_heatmap
    from deepcharuco_tpu_torch.ops.heatmap import gaussian_heatmap

    for cx, cy in ((0, 0), (31, 32), (63, 5), (40, 63)):
        np.testing.assert_array_equal(gaussian_heatmap(cx, cy), jax_heatmap(cx, cy))
        t = gaussian_heatmap(cx, cy, xp=torch)
        assert t.dtype == torch.float32
        assert diff(t.numpy(), jax_heatmap(cx, cy)).max() <= 1e-7


def test_create_label_equals_jax_with_collisions():
    from deepcharuco_tpu.data.dataset import create_label as jax_label
    from deepcharuco_tpu_torch.data import create_label

    r = np.random.default_rng(7)
    for t in range(30):
        n = int(r.integers(0, 40))
        kp = r.uniform(-3, 330, (n, 2)).astype(np.float32)
        kp[: n // 2] = np.floor(kp[: n // 2] / 8) * 8 + 1.5      # shared cells
        ids = r.permutation(n)
        a, b = np.random.default_rng(t), np.random.default_rng(t)
        for x, y in zip(create_label((240, 320), kp, ids, t % 7 == 0, 16, a),
                        jax_label((240, 320), kp, ids, t % 7 == 0, 16, b)):
            np.testing.assert_array_equal(x, y)
        assert a.random() == b.random()


# --- the pipeline against the JAX package --------------------------------------

def numpy_route(ds):
    """The JAX package's numpy route (its native core switched off)."""
    ds.synth._native = None
    if hasattr(ds.source, "_native"):
        ds.source._native = None
    return ds


def assert_images_close(got, want, native):
    """Native route: at most 0.1% of pixels differ; numpy route: at most 1%,
    each by at most 2 levels."""
    d = diff(got, want)
    if native:
        assert (d > 0).mean() <= 0.001
    else:
        assert (d > 0).mean() <= 0.01 and d.max() <= 2


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("refinenet", [False, True])
def test_board_synthesizer_equals_jax(native, refinenet):
    import dataclasses

    from deepcharuco_tpu.data.sources import ProceduralImageSource as JaxSource
    from deepcharuco_tpu.data.synth import BoardSynthesizer as JaxSynth
    from deepcharuco_tpu_torch.data import BoardSynthesizer

    cfg, jcfg = default_config(), jax_default_config()
    if refinenet:
        cfg = dataclasses.replace(cfg, input_size=(640, 480))
        jcfg = dataclasses.replace(jcfg, input_size=(640, 480))
    ours = BoardSynthesizer(cfg, refinenet=refinenet, seed=5, use_native=native)
    theirs = JaxSynth(jcfg, refinenet=refinenet, seed=5)
    if not native:
        theirs._native = None
    np.testing.assert_array_equal(ours.board_img, theirs.board_img)
    photos = JaxSource(size_hw=cfg.input_hw)
    for i in range(3 if refinenet else 6):
        a, b = ours(photos.get(i)), theirs(photos.get(i))
        np.testing.assert_array_equal(a.kpt_ids, b.kpt_ids)
        assert a.is_negative == b.is_negative
        assert diff(a.keypoints, b.keypoints).max(initial=0) <= 1e-5
        assert_images_close(a.image, b.image, native)
    assert ours.rng.random() == theirs.rng.random()


@pytest.mark.parametrize("native", [True, False])
def test_charuco_dataset_equals_jax(native):
    from deepcharuco_tpu.data import CharucoDataset as JaxDataset
    from deepcharuco_tpu_torch.data import CharucoDataset

    ours = CharucoDataset(default_config(), validation=True, use_native=native)
    theirs = JaxDataset(jax_default_config(), validation=True)
    if not native:
        numpy_route(theirs)
    for i in range(6):
        a, b = ours[i], theirs[i]
        np.testing.assert_array_equal(a["loc"], b["loc"])
        np.testing.assert_array_equal(a["ids"], b["ids"])
        assert a["image"].shape == (240, 320, 1) and a["image"].dtype == np.float32
        assert_images_close(a["image"] * 255, b["image"] * 255, native)


@pytest.mark.parametrize("native", [True, False])
def test_refinenet_dataset_equals_jax(native):
    """Corners (heatmaps) equal; patches within the route's bar."""
    from deepcharuco_tpu.data import RefineNetDataset as JaxDataset
    from deepcharuco_tpu_torch.data import RefineNetDataset

    ours = RefineNetDataset(default_config(), validation=True, use_native=native)
    theirs = JaxDataset(jax_default_config(), validation=True)
    if not native:
        numpy_route(theirs)
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert a["patches"].shape == (8, 24, 24, 1) and a["heatmaps"].shape == (8, 64, 64, 1)
        np.testing.assert_array_equal(a["heatmaps"], b["heatmaps"])
        assert_images_close(a["patches"] * 255, b["patches"] * 255, native)


def test_background_bank_equals_jax_bit_for_bit():
    from deepcharuco_tpu.data.device_synth import make_background_bank as jax_bank
    from deepcharuco_tpu_torch.data import make_background_bank

    bank = make_background_bank(8)
    assert bank.shape == (8, 480, 640) and bank.dtype == np.float32
    np.testing.assert_array_equal(bank, jax_bank(8))


def test_bank_from_photos_of_other_sizes(tmp_path):
    r = np.random.default_rng(2)
    for i, shape in enumerate(((600, 800), (480, 640), (300, 400))):
        cv2.imwrite(str(tmp_path / f"{i}.png"), r.integers(0, 256, shape + (3,), np.uint8))
    from deepcharuco_tpu.data.device_synth import make_background_bank as jax_bank
    from deepcharuco_tpu_torch.data import make_background_bank

    got = make_background_bank(4, images_folder=str(tmp_path))
    want = jax_bank(4, images_folder=str(tmp_path))
    assert diff(got, want).max() <= 1


# --- batching, the copy to the device, the native core --------------------------

def test_batch_loader_in_order_equals_indexing():
    from deepcharuco_tpu_torch.data import BatchLoader, CharucoDataset

    cfg = default_config()
    loader = BatchLoader(CharucoDataset(cfg, validation=True), 3, num_workers=1,
                         shuffle=False, max_batches=2)
    direct = CharucoDataset(cfg, validation=True)
    try:
        batches = list(loader)
    finally:
        loader.stop()
    assert len(batches) == 2
    for j, batch in enumerate(batches):
        for k in range(3):
            want = direct[3 * j + k]
            for key in ("image", "loc", "ids"):
                np.testing.assert_array_equal(batch[key][k], want[key])


def test_device_prefetch_passes_arrays_through_on_the_cpu():
    from deepcharuco_tpu_torch.data import device_prefetch

    batches = [{"image": np.full((2, 4, 4, 1), i, np.float32),
                "loc": np.full((2, 3), i, np.int32)} for i in range(5)]
    got = list(device_prefetch(iter(batches), size=2, device="cpu"))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert b["image"].dtype == torch.float32 and b["loc"].dtype == torch.int32
        np.testing.assert_array_equal(b["image"].numpy(), batches[i]["image"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(device_prefetch(iter(batches)))


def test_native_core_builds_under_build_and_raises_when_it_cannot(monkeypatch, tmp_path):
    from deepcharuco_tpu_torch.data import native

    path = native.lib_path()
    assert path.parent == native.ROOT / "build" / "native"
    native.load()
    assert path.exists()
    before = sorted(os.listdir(os.path.join(ROOT, "native")))
    assert before == sorted(os.listdir(os.path.join(ROOT, "native")))
    bad = tmp_path / "dcsynth.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()
    from deepcharuco_tpu_torch.data import CharucoDataset

    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        CharucoDataset(default_config(), validation=True)
    CharucoDataset(default_config(), validation=True, use_native=False)[0]


def test_procedural_pipeline_runs_without_cv2(tmp_path):
    code = """
import sys
sys.modules["cv2"] = None
import numpy as np
from deepcharuco_tpu_torch.configs import default_config
from deepcharuco_tpu_torch.data import (CharucoDataset, RefineNetDataset, DirectoryImageSource,
                                        make_background_bank)
cfg = default_config()
for native in (True, False):
    d = CharucoDataset(cfg, validation=True, use_native=native)[0]
    assert d["image"].shape == (240, 320, 1) and np.isfinite(d["image"]).all()
    r = RefineNetDataset(cfg, validation=True, use_native=native)[0]
    assert r["patches"].shape == (8, 24, 24, 1)
    assert make_background_bank(2, use_native=native).shape == (2, 480, 640)
try:
    DirectoryImageSource(sys.argv[1]).get(0)
except SystemExit as e:
    assert "cv2" in str(e), e
else:
    raise AssertionError("a JPEG was read without cv2")
from deepcharuco_tpu_torch.data import png
png.write_png(sys.argv[1] + "/b.png", np.full((4, 5, 3), 7, np.uint8))
assert (DirectoryImageSource(sys.argv[1]).get(1) == 7).all()   # PNG: no cv2 needed
print("ok")
"""
    (tmp_path / "a.jpg").write_bytes(b"not read")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


def test_chip_smoke_host_agreement_on_the_cpu():
    """``chip_smoke.py`` phase 15's check of the stored JAX host samples, on
    the CPU: every bar met, and here (the JAX package's own native build's
    floating point) the native route and the bank bit-equal."""
    import chip_smoke

    res = chip_smoke.host_fixture_agreement(dict(np.load(chip_smoke.FIXTURE)))
    assert res["bank"]["share"] == 0
    assert res["native detector images"]["share"] == 0
    assert res["native RefineNet patches"]["share"] == 0

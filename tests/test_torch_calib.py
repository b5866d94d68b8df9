"""Camera calibration without cv2 (``deepcharuco_tpu_torch/calib.py`` and
``cli/calib_intrinsics.py``) against cv2 5.0.0 and the JAX package's
``cli.calib_intrinsics`` on the CPU.

Measured gaps to cv2 (4 seeds of 10 synthetic views, both flag sets;
``scripts/probe_torch_port_calib.py`` prints them) and the bounds held
here, about 5× over them:

- ``project_points``: 1e-13 px (held 1e-9 relative); ``rodrigues`` 1e-15;
- ``calibrate_camera``: K 9.6e-10 of fx (held 5e-9), dist 2.8e-6 absolute
  (held 1.5e-5; the weakly determined k3 of seed 2), rms 5e-15 relative
  (held 5e-14), rvecs 1.1e-9 and tvecs 8.1e-10 (held 5e-9);
- corners after ``corner_sub_pix(11, 30, 0.001)``: 0.00092 px (the
  contract's 0.01 px is held);
- ``--charuco`` K against the JAX CLI's on the same PNGs: fx/fy 0.031%,
  cx/cy 0.09 px (held 0.2% and 0.5 px; bf16 networks on both sides);
- the chessboard mode on 10 tilted views: K within 3.2e-6 of fx of the JAX
  CLI's (held 3e-5).

The five boards of ``tests/test_cli.py::test_calib_cli`` are near-frontal
and the JAX CLI fits the full distortion model to them, which they do not
determine: cv2's own fx goes 5,163 → 9,834 → 113,228 → 514,744 after 1, 30,
500 (its default) and 5,000 trials. The port's K there is not held to
JAX's; its corners, found flags and reprojection error are.
"""

import os
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from deepcharuco_tpu.cli import calib_intrinsics as jax_cli  # noqa: E402
from deepcharuco_tpu_torch import calib  # noqa: E402
from deepcharuco_tpu_torch.cli import calib_intrinsics as cli  # noqa: E402
from deepcharuco_tpu_torch.data import cvnp, png  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_frames.npz")
DET = "artifacts/detector_devsynth.npz"
RN32 = "artifacts/refinenet32_devsynth.npz"
CPU = ["--device", "cpu"]
SUBPIX = 0.01                   # px, corners after the 11×11 refinement
FLAGS = [0, cv2.CALIB_ZERO_TANGENT_DIST | cv2.CALIB_FIX_K3]
CB_FLAGS = cv2.CALIB_CB_ADAPTIVE_THRESH | cv2.CALIB_CB_FAST_CHECK | cv2.CALIB_CB_NORMALIZE_IMAGE
TERM = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 0.001)
OBJ = np.zeros((54, 3))
OBJ[:, :2] = np.mgrid[0:9, 0:6].T.reshape(-1, 2) * 0.03


@pytest.fixture(scope="module")
def fix():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files if k.startswith("calib/")}


def synthetic_views(seed, n=10):
    """n views of a 9×6 grid by a distorted camera, 0.2 px noise."""
    rng = np.random.default_rng(seed)
    K = np.array([[600.0, 0, 320], [0, 590.0, 240], [0, 0, 1]])
    dist = np.array([0.1, -0.2, 0.001, -0.002, 0.05])
    objs, imgs = [], []
    for _ in range(n):
        r = np.array([rng.uniform(-.5, .5), rng.uniform(-.5, .5), rng.uniform(-3, 3)])
        t = np.array([rng.uniform(-.03, .03), rng.uniform(-.03, .03), rng.uniform(.5, .8)]) \
            - cv2.Rodrigues(r)[0] @ OBJ.mean(0)
        p = cv2.projectPoints(OBJ, r, t, K, dist)[0] + rng.normal(0, 0.2, (54, 1, 2))
        objs.append(OBJ.astype(np.float32))
        imgs.append(p.astype(np.float32))
    return objs, imgs


# --- rotations, projection, the solver -----------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_rodrigues_and_project_points_equal_cv2(seed):
    rng = np.random.default_rng(seed)
    K = np.array([[600.0, 0, 320], [0, 590.0, 240], [0, 0, 1]])
    r = rng.normal(0, 1.0, 3)
    t = np.array([-.1, -.1, .6]) + rng.normal(0, .05, 3)
    R = cv2.Rodrigues(r)[0]
    np.testing.assert_allclose(calib.rodrigues(r), R, atol=1e-15)
    np.testing.assert_allclose(calib.rodrigues(R), cv2.Rodrigues(R)[0].ravel(), atol=1e-14)
    for dist in (None, np.array([0.1, -0.2, 0.001, -0.002, 0.05])):
        want = cv2.projectPoints(OBJ, r, t, K, dist)[0][:, 0]
        np.testing.assert_allclose(calib.project_points(OBJ, r, t, K, dist), want, rtol=1e-9)
    np.testing.assert_allclose(calib.rodrigues(np.zeros(3)), np.eye(3))
    np.testing.assert_allclose(calib.rodrigues(cv2.Rodrigues(np.array([np.pi, 0, 0]))[0]),
                               cv2.Rodrigues(cv2.Rodrigues(np.array([np.pi, 0, 0]))[0])[0]
                               .ravel(), atol=1e-12)


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("seed", range(4))
def test_calibrate_camera_equals_cv2(seed, flags):
    objs, imgs = synthetic_views(seed)
    rms, K, dist, rvecs, tvecs = cv2.calibrateCamera(objs, imgs, (640, 480), None, None,
                                                     flags=flags)
    got = calib.calibrate_camera(objs, imgs, (640, 480), flags)
    assert abs(got[0] - rms) <= 5e-14 * rms
    assert np.abs(got[1] - K).max() <= 5e-9 * K[0, 0]
    assert got[2].shape == (1, 5)
    assert np.abs(got[2] - dist).max() <= 1.5e-5
    assert np.abs(np.array(got[3]) - np.array(rvecs)).max() <= 5e-9
    assert np.abs(np.array(got[4]) - np.array(tvecs)).max() <= 5e-9
    if flags:
        assert (got[2][0, 2:] == 0).all()


def test_calibrate_camera_refuses_what_it_does_not_restate():
    objs, imgs = synthetic_views(0, 3)
    with pytest.raises(ValueError, match="flags"):
        calib.calibrate_camera(objs, imgs, (640, 480), cv2.CALIB_FIX_ASPECT_RATIO)
    lifted = [o + np.float32([0, 0, 0.01]) for o in objs]
    with pytest.raises(ValueError, match="non-planar"):
        calib.calibrate_camera(lifted, imgs, (640, 480))


def test_corner_sub_pix_of_many_points_equals_one_at_a_time():
    """``cvnp.corner_sub_pix`` moves each point of a batch as it moves that
    point alone (inside the image and at its borders)."""
    rng = np.random.default_rng(1)
    img = cv2.GaussianBlur((rng.random((120, 160)) > 0.5).astype(np.uint8) * 200, (0, 0), 3)
    pts = np.stack([rng.uniform(-2, 162, 150), rng.uniform(-2, 122, 150)], 1).astype(np.float32)
    for win, iters, eps in ((5, 30, 0.001), (2, 15, 0.1), (11, 30, 0.001)):
        want = np.stack([cvnp.corner_sub_pix(img, p, win, iters, eps) for p in pts])
        np.testing.assert_array_equal(cvnp.corner_sub_pix(img, pts, win, iters, eps), want)


# --- the chessboard finder -----------------------------------------------

def _blurred_noisy(frames, seed=0):
    rng = np.random.default_rng(seed)
    return [np.clip(cv2.GaussianBlur(f, (5, 5), 1.5).astype(np.float32)
                    + rng.normal(0, 8, f.shape), 0, 255).astype(np.uint8) for f in frames]


def _boards(fix):
    chess = list(fix["calib/chess/frames"])
    return {"test_cli boards": chess, "blurred and noisy": _blurred_noisy(chess),
            "tilted": list(fix["calib/tilted/frames"])}


@pytest.mark.parametrize("name", ["test_cli boards", "blurred and noisy", "tilted"])
def test_chessboard_corners_are_cv2s(fix, name):
    """Found where cv2 finds the board; after the CLI's 11×11 refinement
    the corners are cv2's within 0.01 px, in cv2's order or turned by 180°."""
    for gray in _boards(fix)[name]:
        found, want = cv2.findChessboardCorners(gray, (9, 6), CB_FLAGS)
        got_found, got = calib.find_chessboard_corners(gray, (9, 6))
        assert found and got_found
        assert got.shape == (54, 1, 2) and got.dtype == np.float32
        want = cv2.cornerSubPix(gray, want, (11, 11), (-1, -1), TERM).reshape(-1, 2)
        got = cvnp.corner_sub_pix(gray, got, 11, 30, 0.001).reshape(-1, 2)
        assert min(np.abs(got - want).max(), np.abs(got[::-1] - want).max()) <= SUBPIX


def test_chessboard_rejections_match_cv2(fix):
    """No board, a board cut by the frame, the wrong pattern size."""
    board = fix["calib/chess/frames"][0]
    cases = [(np.full((480, 640), 128, np.uint8), (9, 6)), (board[:, :380].copy(), (9, 6)),
             (board, (8, 6)), (board, (9, 7))]
    for gray, size in cases:
        assert not cv2.findChessboardCorners(gray, size, CB_FLAGS)[0]
        assert calib.find_chessboard_corners(gray, size) == (False, None)


# --- the CLI against the JAX package's ------------------------------------

def _write_pngs(d, frames):
    d.mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(d / f"v_{i:03d}.png"), f)
    return str(d)


def _port_main(argv):
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = None                  # no cv2 anywhere on the port's path
    try:
        return cli.main(argv + CPU)
    finally:
        sys.modules["cv2"] = saved


@pytest.fixture(scope="module")
def charuco_runs(fix, tmp_path_factory):
    """Both CLIs' ``--charuco`` on the 10 known-camera views as PNGs."""
    tmp = tmp_path_factory.mktemp("charuco")
    d = _write_pngs(tmp / "views", fix["calib/views"])
    jax_cli.main([d, "--charuco", "--stride", "1", "--out", str(tmp / "jax.npz")])
    _port_main([d, "--charuco", "--out", str(tmp / "port.npz")])
    return {k: dict(np.load(tmp / f"{k}.npz")) for k in ("jax", "port")}


def test_charuco_cli_recovers_the_camera_and_agrees_with_jax(fix, charuco_runs):
    K = charuco_runs["port"]["camera_matrix"]
    K_jax = charuco_runs["jax"]["camera_matrix"]
    K_true = fix["calib/K_true"]
    assert charuco_runs["port"]["distortion_coeffs"].shape == (1, 5)
    for i in (0, 1):                     # tests/test_charuco_calib.py's limits
        assert abs(K[i, i] - K_true[i, i]) / K_true[i, i] < 0.015
        assert abs(K[i, 2] - K_true[i, 2]) < 4.0
        assert abs(K[i, i] - K_jax[i, i]) / K_jax[i, i] <= 2e-3
        assert abs(K[i, 2] - K_jax[i, 2]) <= 0.5
    np.testing.assert_allclose(K_jax, fix["calib/clean/K"], rtol=1e-6)   # the stored run


def test_charuco_low_light_set(fix):
    """``tests/test_charuco_calib.py:170-173``'s limits on the stored
    low-light views."""
    from deepcharuco_tpu_torch.configs import default_config

    timings = {}
    K, dist, err, used = cli.charuco_calibrate(fix["calib/dark"], default_config(), DET, RN32,
                                               verbose=False, device="cpu", timings=timings)
    K_true = fix["calib/K_true"]
    assert used >= 9 and used >= fix["calib/dark/used"] - 1
    assert abs(K[0, 0] - K_true[0, 0]) / K_true[0, 0] < 0.015
    assert abs(K[1, 1] - K_true[1, 1]) / K_true[1, 1] < 0.015
    assert err < 0.6
    assert set(timings) == {"detect_s", "solve_s"}


@pytest.fixture(scope="module")
def chessboard_runs(fix, tmp_path_factory):
    """Both CLIs' chessboard mode on the tilted views and on the five
    boards of ``tests/test_cli.py``, as BGR PNGs."""
    tmp = tmp_path_factory.mktemp("chess")
    out = {}
    for name in ("tilted", "chess"):
        d = _write_pngs(tmp / name, [cv2.cvtColor(f, cv2.COLOR_GRAY2BGR)
                                     for f in fix[f"calib/{name}/frames"]])
        jax_cli.main([d, "--stride", "1", "--out", str(tmp / f"{name}_jax.npz")])
        _port_main([d, "--stride", "1", "--out", str(tmp / f"{name}_port.npz")])
        out[name] = {k: np.load(tmp / f"{name}_{k}.npz")["camera_matrix"]
                     for k in ("jax", "port")}
    return out


def test_chessboard_cli_agrees_with_jax_on_tilted_views(fix, chessboard_runs):
    K, K_jax = chessboard_runs["tilted"]["port"], chessboard_runs["tilted"]["jax"]
    assert np.abs(K - K_jax).max() <= 3e-5 * K_jax[0, 0]
    assert np.abs(K - fix["calib/tilted/K_true"]).max() < 1.0


def test_chessboard_cli_on_the_test_cli_boards(fix, chessboard_runs, capsys):
    """Found on all five, corners as cv2's (stored), and a fit that explains
    them; K itself is not determined by these views (module docstring)."""
    frames = fix["calib/chess/frames"]
    for gray, want in zip(frames, fix["calib/chess/corners"]):
        found, got = calib.find_chessboard_corners(gray, (9, 6))
        got = cvnp.corner_sub_pix(gray, got, 11, 30, 0.001).reshape(-1, 2)
        assert found and min(np.abs(got - want).max(), np.abs(got[::-1] - want).max()) <= SUBPIX
    K, dist, err, used = cli.chessboard_calibrate(list(frames), (9, 6))
    assert used == 5 and err < 0.1 and np.isfinite(K).all()
    assert chessboard_runs["chess"]["port"].shape == (3, 3)


def test_advice_repairs_hires_crop_and_stride(tmp_path, monkeypatch):
    """``--charuco --hires S`` crops to multiples of 8·S (ADVICE.md:3);
    ``--stride`` defaults to 1 with ``--charuco`` and 5 without (:5)."""
    rng = np.random.default_rng(0)
    d = _write_pngs(tmp_path / "f", rng.integers(0, 256, (7, 56, 88), dtype=np.uint8))
    seen = {}
    monkeypatch.setattr(cli, "charuco_calibrate",
                        lambda frames, *a, **k: seen.update(charuco=frames.shape)
                        or (np.eye(3), np.zeros((1, 5)), 0.0, len(frames)))
    monkeypatch.setattr(cli, "chessboard_calibrate",
                        lambda frames, pattern: seen.update(chess=len(frames))
                        or (np.eye(3), np.zeros((1, 5)), 0.0, len(frames)))
    cli.main([d, "--charuco", "--hires", "2", "--out", str(tmp_path / "a.npz")] + CPU)
    assert seen["charuco"] == (7, 48, 80)              # 56 × 88 → multiples of 16
    cli.main([d, "--charuco", "--out", str(tmp_path / "b.npz")] + CPU)
    assert seen["charuco"] == (7, 56, 88)              # multiples of 8, every frame
    cli.main([d, "--out", str(tmp_path / "c.npz")] + CPU)
    assert seen["chess"] == 2                          # frames 0 and 5
    frames = cli.load_gray_frames(sorted(str(p) for p in (tmp_path / "f").glob("*.png")), 32)
    assert frames.shape == (7, 32, 64)


def test_frame_arrays_and_unreadable_frames(tmp_path, fix, monkeypatch):
    """A ``.npy`` of gray frames goes in like a PNG directory; a directory
    without PNGs, or with nothing readable, exits with a message."""
    seen = {}
    monkeypatch.setattr(cli, "charuco_calibrate",
                        lambda frames, *a, **k: seen.update(shape=frames.shape)
                        or (np.eye(3), np.zeros((1, 5)), 0.0, len(frames)))
    np.save(tmp_path / "v.npy", fix["calib/views"][:, :237])
    cli.main([str(tmp_path / "v.npy"), "--charuco"] + CPU)
    assert seen["shape"] == (10, 232, 320)
    assert os.path.exists(tmp_path / "camera_params.npz")
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no \\*.png"):
        cli.main([str(tmp_path / "empty")] + CPU)
    (tmp_path / "empty" / "x.png").write_bytes(b"broken")
    with pytest.raises(SystemExit, match="no readable frames"):
        cli.main([str(tmp_path / "empty"), "--charuco"] + CPU)


def test_without_a_card_both_modes_refuse_the_cpu_unasked(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    png.write_png(tmp_path / "a.png", np.zeros((16, 16), np.uint8))
    for flags in ([], ["--charuco"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main([str(tmp_path)] + flags)

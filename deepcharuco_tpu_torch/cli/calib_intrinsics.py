"""Camera-intrinsics calibration CLI (``deepcharuco_tpu.cli.calib_intrinsics``):
``camera_params.npz`` (``camera_matrix``, ``distortion_coeffs``) for
``pipeline.Camera.from_npz``, from ``*.png`` frames or a ``.npy``/``.npz``
array of uint8 frames, with no cv2.

Two modes, as in the JAX package:

- ``--charuco``: views of the ChArUco board itself. The network finds the
  corners on the card (:func:`charuco_calibrate`: ``InferencePipeline.detect``
  in batches of ``--batch``, the decode kernel B1); each view's refined
  corners are paired by id with the board's object points and the camera is
  solved on the host by :func:`~deepcharuco_tpu_torch.calib.calibrate_camera`
  (numpy float64, cv2's solver restated). Only measured corners feed the
  solver; ``--geom-decode`` never fills.
- a chessboard of ``--pattern`` inner corners, found by
  :func:`~deepcharuco_tpu_torch.calib.find_chessboard_corners` and refined by
  :func:`~deepcharuco_tpu_torch.data.cvnp.corner_sub_pix` (11 × 11 window), all on
  the host.

Two choices differ from the JAX CLI on purpose (``ROADMAP.md`` §C): with
``--charuco --hires S`` frames are cropped to multiples of 8·S (the detector
runs on the S×-pooled view, whose decode grid needs multiples of 8), and
``--stride`` defaults to 1 with ``--charuco`` (a ChArUco capture is a few
deliberate views) and to 5 without (chessboard video).

Run: ``python -m deepcharuco_tpu_torch.cli.calib_intrinsics DIR --charuco
[--device cpu]``; the card is the default.
"""

from __future__ import annotations

import argparse
import glob
import os
import time


def build_argparser():
    p = argparse.ArgumentParser(description="Camera intrinsics calibration")
    p.add_argument("image_dir",
                   help="directory with calibration *.png frames, or a .npy/.npz file of "
                        "uint8 frames")
    p.add_argument("--pattern", default="9x6",
                   help="inner-corner grid for chessboard mode, e.g. 9x6")
    p.add_argument("--stride", type=int, default=None,
                   help="use every Nth frame (default: 1 with --charuco, 5 without)")
    p.add_argument("--out", default=None,
                   help="output npz (default <dir>/camera_params.npz)")
    p.add_argument("--charuco", action="store_true",
                   help="calibrate from ChArUco-board views via the deep two-stage "
                        "pipeline instead of a chessboard")
    p.add_argument("--config", default=None,
                   help="board yaml for --charuco (default: built-in config)")
    p.add_argument("--deepc", default="artifacts/detector_devsynth.npz",
                   help="detector weights for --charuco")
    p.add_argument("--refinenet", default="artifacts/refinenet32_devsynth.npz",
                   help="RefineNet weights for --charuco")
    p.add_argument("--rn-patch-size", type=int, choices=[24, 32], default=32,
                   help="RefineNet patch size matching --refinenet")
    p.add_argument("--rn-decode", default="avg", choices=["hard", "soft", "offset", "avg"],
                   help="RefineNet decode for --charuco")
    p.add_argument("--geom-decode", action="store_true",
                   help="geometry-consistent candidate reselection (measured detections "
                        "only; fills never feed calibration)")
    p.add_argument("--hires", nargs="?", type=int, const=2, default=0,
                   help="hi-res patch tap: detector on the pooled view, RefineNet patches "
                        "at native resolution")
    p.add_argument("--min-corners", type=int, default=6,
                   help="per-view acceptance gate for --charuco")
    p.add_argument("--batch", type=int, default=16,
                   help="frames per pipeline dispatch for --charuco")
    p.add_argument("--full-dist", action="store_true",
                   help="fit the full 5-coeff distortion model (default: zero tangential "
                        "+ fixed k3, the stable choice for small view counts)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain versions)")
    return p


def read_gray(path: str):
    """A frame as ``cvtColor(imread(path), COLOR_BGR2GRAY)`` gives it, or
    None when the file cannot be read: ``.png`` through the port's decoder,
    other formats through cv2."""
    from deepcharuco_tpu_torch.cli import imread
    from deepcharuco_tpu_torch.data import cvnp

    img = imread(path)
    return None if img is None else cvnp.bgr2gray(img)


def load_gray_frames(paths, multiple: int = 8):
    """Read frames as grayscale uint8, cropped to H/W multiples of
    ``multiple`` (8, or 8·S under the hi-res tap at scale S).

    Cropping the bottom/right edges keeps the pixel origin (and therefore
    the intrinsics being estimated) unchanged; the detector's stride-8
    decode grid requires the multiple-of-8 shape.
    """
    import numpy as np

    frames = []
    for path in paths:
        gray = read_gray(path)
        if gray is None:
            continue
        h, w = gray.shape
        frames.append(gray[: h - h % multiple, : w - w % multiple])
    if not frames:
        raise SystemExit("no readable frames")
    shape = frames[0].shape
    if any(f.shape != shape for f in frames):
        raise SystemExit("calibration frames must share one resolution")
    return np.stack(frames)


def _gray_array(path: str, stride: int, multiple: int):
    """Frames of a ``.npy``/``.npz`` array as gray, every ``stride``-th,
    cropped to multiples of ``multiple``."""
    import numpy as np

    from deepcharuco_tpu_torch.cli import load_frame_array
    from deepcharuco_tpu_torch.data import cvnp

    frames = load_frame_array(path)[::stride]
    if frames.ndim == 4:
        frames = np.stack([cvnp.bgr2gray(f) for f in frames])
    h, w = frames.shape[1:3]
    return np.ascontiguousarray(frames[:, : h - h % multiple, : w - w % multiple])


def charuco_calibrate(frames, config, deepc, refinenet, *,
                      rn_patch_size: int = 32, rn_decode: str = "avg",
                      geom_decode: bool = False, hires=0,
                      min_corners: int = 6, batch: int = 16,
                      simple_dist: bool = True, verbose: bool = True,
                      device=None, timings=None):
    """Intrinsics from ChArUco-board views via the deep pipeline.

    The correspondence set is exactly the pose path's: refined sub-pixel
    corners paired with :func:`board.inner_corner_object_points` rows by
    corner id, fed to :func:`calib.calibrate_camera` per view.

    frames: (N, H, W) uint8 grayscale, H/W multiples of 8 (8·S under the
    hi-res tap). ``timings``, a dict, receives ``detect_s`` and ``solve_s``.
    Returns ``(K, dist, mean_reprojection_px, n_views_used)``.
    """
    import numpy as np

    from deepcharuco_tpu_torch import calib
    from deepcharuco_tpu_torch.board import inner_corner_object_points
    from deepcharuco_tpu_torch.pipeline import load_pipeline

    pipe = load_pipeline(config, deepc, refinenet, rn_patch_size=rn_patch_size,
                         rn_decode=rn_decode, geom_decode=geom_decode, hires=hires,
                         device=device)
    object_points = inner_corner_object_points(config.row_count, config.col_count,
                                               config.square_len)

    t0 = time.perf_counter()
    obj_list, img_list = [], []
    n, h, w = frames.shape[:3]
    for start in range(0, n, batch):
        chunk = frames[start:start + batch]
        _, valid, refined = pipe.detect(chunk)
        for i in range(len(chunk)):
            ids = np.nonzero(valid[i])[0]
            if len(ids) < min_corners:
                continue
            pts = pipe.input_coords(refined[i][ids])
            obj_list.append(object_points[ids])
            img_list.append(np.asarray(pts, np.float32).reshape(-1, 1, 2))
    t1 = time.perf_counter()

    if len(obj_list) < 3:
        raise SystemExit(f"only {len(obj_list)}/{n} views passed the >= {min_corners}"
                         f"-corner gate; need >= 3 usable views")
    if verbose:
        per_view = [len(o) for o in obj_list]
        print(f"calibrating on {len(obj_list)}/{n} views "
              f"({min(per_view)}-{max(per_view)} corners each)...")
    flags = calib.CALIB_ZERO_TANGENT_DIST | calib.CALIB_FIX_K3 if simple_dist else 0
    _, K, dist, rvecs, tvecs = calib.calibrate_camera(obj_list, img_list, (w, h), flags)

    err = 0.0
    for i in range(len(obj_list)):
        proj = calib.project_points(obj_list[i], rvecs[i], tvecs[i], K, dist)
        diff = img_list[i].reshape(-1, 2).astype(np.float64) - proj
        err += float(np.sqrt(np.mean(np.sum(diff ** 2, axis=1))))
    err /= len(obj_list)
    if timings is not None:
        timings.update(detect_s=t1 - t0, solve_s=time.perf_counter() - t1)
    if verbose:
        print(f"mean reprojection error: {err:.4f} px")
    return K, dist, err, len(obj_list)


def chessboard_calibrate(gray_frames, pattern, verbose: bool = True):
    """Intrinsics from chessboard views (the JAX CLI's default mode):
    corners by :func:`calib.find_chessboard_corners`, refined over an 11 × 11
    window (30 iterations or 0.001 px), the full distortion model.
    ``gray_frames``: uint8 (H, W) frames of one size. Returns ``(K, dist,
    mean_reprojection_px, n_views_used)``; the error is the JAX CLI's (per
    view the norm of all residuals over the corner count)."""
    import numpy as np

    from deepcharuco_tpu_torch import calib
    from deepcharuco_tpu_torch.data import cvnp

    cols, rows = pattern
    objp = np.zeros((cols * rows, 3), np.float32)
    objp[:, :2] = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2)
    obj_points, img_points, shape = [], [], None
    for gray in gray_frames:
        shape = gray.shape[::-1]
        found, corners = calib.find_chessboard_corners(gray, (cols, rows))
        if found:
            img_points.append(cvnp.corner_sub_pix(gray, corners, 11, 30, 0.001)
                              .reshape(-1, 1, 2))
            obj_points.append(objp)
    if len(obj_points) < 3:
        raise SystemExit(f"only {len(obj_points)} usable frames; need >= 3")
    if verbose:
        print(f"calibrating on {len(obj_points)} frames...")
    _, K, dist, rvecs, tvecs = calib.calibrate_camera(obj_points, img_points, shape, 0)
    err = 0.0
    for i in range(len(obj_points)):
        proj = calib.project_points(obj_points[i], rvecs[i], tvecs[i], K, dist)
        diff = img_points[i].reshape(-1, 2).astype(np.float64) - proj
        err += float(np.linalg.norm(diff)) / len(proj)
    err /= len(obj_points)
    if verbose:
        print(f"mean reprojection error: {err:.4f} px")
    return K, dist, err, len(obj_points)


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import numpy as np

    from deepcharuco_tpu_torch._device import resolve_device
    from deepcharuco_tpu_torch.cli import is_array_file

    device = resolve_device(args.device)
    stride = args.stride or (1 if args.charuco else 5)
    multiple = 8 * (args.hires or 1) if args.charuco else 1
    if is_array_file(args.image_dir):
        frames = _gray_array(args.image_dir, stride, multiple)
        out_dir = os.path.dirname(os.path.abspath(args.image_dir))
    else:
        paths = sorted(glob.glob(os.path.join(args.image_dir, "*.png")))
        if not paths:
            raise SystemExit(f"no *.png frames under {args.image_dir}")
        frames = load_gray_frames(paths[::stride], multiple) if args.charuco else \
            [g for g in map(read_gray, paths[::stride]) if g is not None]
        out_dir = args.image_dir

    if args.charuco:
        from deepcharuco_tpu_torch.configs import default_config, load_configuration

        config = load_configuration(args.config) if args.config else default_config()
        K, dist, _, _ = charuco_calibrate(
            frames, config, args.deepc, args.refinenet,
            rn_patch_size=args.rn_patch_size, rn_decode=args.rn_decode,
            geom_decode=args.geom_decode, hires=args.hires,
            min_corners=args.min_corners, batch=args.batch,
            simple_dist=not args.full_dist, device=device)
    else:
        cols, rows = (int(v) for v in args.pattern.split("x"))
        if len(frames) == 0:
            raise SystemExit("no readable frames")
        if any(f.shape != frames[0].shape for f in frames):
            raise SystemExit("calibration frames must share one resolution")
        K, dist, _, _ = chessboard_calibrate(frames, (cols, rows))
    out = args.out or os.path.join(out_dir, "camera_params.npz")
    np.savez(out, camera_matrix=K, distortion_coeffs=dist)
    print(f"saved {out}")
    return K, dist


if __name__ == "__main__":
    main()

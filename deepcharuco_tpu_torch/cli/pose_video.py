"""Board pose over a video's frames (``deepcharuco_tpu.cli.pose_video``).

Frames go through the pipeline in device batches (detect + batched PnP in
one call, the pose tail replayed from a CUDA graph on the card); the poses
can be made robust (``--ransac``: the port's ``pnp.ransac``, subsets drawn
from a ``torch.Generator`` seeded 0) and smoothed over time (``--smooth``:
``pose_filter.PoseFilter``). The frames, corners and axes are then drawn
and written as an mp4, beside the classical cv2.aruco estimate with
``--cv2-baseline``; drawing, the mp4 and ``*.png`` frame directories need
cv2. Frames may also come as a ``.npy``/``.npz`` file of uint8 frames, and
``--no-video`` prints each frame's pose instead of drawing: that path needs
no cv2. :func:`estimate` is the core.

Run: ``python -m deepcharuco_tpu_torch.cli.pose_video frames_dir [--device cpu]``.
"""

from __future__ import annotations

import argparse
import glob
import os


def build_argparser():
    p = argparse.ArgumentParser(description="Board pose over a frame directory")
    p.add_argument("input_dir",
                   help="directory of *.png frames (cv2), or a .npy/.npz file of uint8 frames")
    p.add_argument("--config", default=None)
    p.add_argument("--deepc", default=None)
    p.add_argument("--refinenet", default=None)
    p.add_argument("--camera", default=None,
                   help="camera_params.npz (camera_matrix, distortion_coeffs)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--out", default=None, help="output mp4 (default res.mp4 beside the input)")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--no-video", action="store_true",
                   help="print each frame's pose instead of writing the mp4 (no cv2)")
    p.add_argument("--cv2-baseline", action="store_true",
                   help="render the classical cv2.aruco estimate side by side")
    p.add_argument("--ransac", action="store_true",
                   help="robust pose: RANSAC over the detections instead of plain least "
                        "squares")
    p.add_argument("--hires", nargs="?", type=int, const=2, default=0, choices=[2, 4],
                   metavar="SCALE",
                   help="hi-res patch tap: frames at SCALE× the config resolution (bare "
                        "flag = 2); --camera is the one calibrated at the frame resolution")
    p.add_argument("--rn-patch-size", type=int, choices=[24, 32], default=24)
    p.add_argument("--rn-decode", choices=["hard", "soft", "offset", "avg"], default=None)
    p.add_argument("--geom-decode", action="store_true",
                   help="geometry-consistent decode (ops/geom.py)")
    p.add_argument("--geom-fill", action="store_true",
                   help="with --geom-decode: predict and refine undetected in-frame corners")
    p.add_argument("--smooth", action="store_true",
                   help="temporal pose filter: constant-velocity smoothing, planar flip "
                        "rejection, coasting through short dropouts")
    p.add_argument("--smooth-gate-deg", type=float, default=15.0,
                   help="with --smooth: per-frame rotation innovation gate")
    p.add_argument("--smooth-max-coast", type=int, default=5,
                   help="with --smooth: frames predicted through a dropout before the "
                        "track is declared lost")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain versions)")
    return p


def estimate(pipe, batches, camera=None, ransac: bool = False, pose_filter=None,
             stats=None, generator=None):
    """Per frame of ``batches`` (uint8 frame arrays), in order: (keypoints,
    valid, refined, ok, rvec, tvec) numpy arrays, corners in the input
    frame's pixels. ``ransac`` solves with ``pnp.ransac`` on ``camera``
    (calibrated at the input resolution; subsets from ``generator``, None →
    a generator on the pipeline's device seeded 0) in place of the
    pipeline's least squares; ``pose_filter`` (a ``PoseFilter``) smooths
    the poses in frame order, counting its states into ``stats``."""
    import numpy as np
    import torch

    from deepcharuco_tpu_torch.pnp.ransac import solve_pnp_ransac_batch

    if ransac and generator is None:
        generator = torch.Generator(device=pipe.device).manual_seed(0)
    for frames in batches:
        if ransac:
            kp, valid, refined = pipe.detect(frames)
            # the detections are in the pipeline's working units (the pooled
            # view under hires): solve with the matching intrinsics
            cam = camera.scaled(1.0 / pipe.hires_scale) if pipe.hires else camera
            to = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(pipe.device)
            ok, rvec, tvec, _, _ = solve_pnp_ransac_batch(
                pipe.object_points, to(refined), torch.as_tensor(valid).to(pipe.device),
                to(cam.K), to(cam.dist), generator)
            ok, rvec, tvec = (t.cpu().numpy() for t in (ok, rvec, tvec))
        else:
            kp, valid, refined, ok, rvec, tvec, _ = pipe.detect_with_pose(frames)
        kp, refined = pipe.input_coords(kp), pipe.input_coords(refined)
        for j in range(len(frames)):
            o, r, t = bool(ok[j]), rvec[j], tvec[j]
            if pose_filter is not None:
                o, r, t, state = pose_filter.update(o, np.asarray(r, np.float64).reshape(3),
                                                    np.asarray(t, np.float64).reshape(3))
                if stats is not None:
                    stats[state] = stats.get(state, 0) + 1
            yield kp[j], valid[j], refined[j], o, np.asarray(r), np.asarray(t)


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import numpy as np

    from deepcharuco_tpu_torch import board as B
    from deepcharuco_tpu_torch.cli import is_array_file, load_frame_array, need_cv2
    from deepcharuco_tpu_torch.configs import default_config, load_configuration
    from deepcharuco_tpu_torch.pipeline import Camera, load_pipeline
    from deepcharuco_tpu_torch.pose_filter import PoseFilter

    cv2 = None
    if not args.no_video or args.cv2_baseline:
        cv2 = need_cv2("the mp4 (leave it out with --no-video)" if not args.no_video
                       else "--cv2-baseline")
    if is_array_file(args.input_dir):
        all_frames = load_frame_array(args.input_dir)
        chunks = [all_frames[i:i + args.batch] for i in range(0, len(all_frames), args.batch)]
        n_total = len(all_frames)
        out_dir = os.path.dirname(os.path.abspath(args.input_dir))
    else:
        cv2 = need_cv2("reading *.png frames")
        paths = sorted(glob.glob(os.path.join(args.input_dir, "*.png")))
        if not paths:
            raise SystemExit(f"no *.png frames under {args.input_dir}")
        chunks = (np.stack([cv2.imread(p) for p in paths[i:i + args.batch]])
                  for i in range(0, len(paths), args.batch))
        n_total = len(paths)
        out_dir = args.input_dir

    cfg = load_configuration(args.config) if args.config else default_config()
    if args.camera:
        camera = Camera.from_npz(args.camera)
    else:
        # a nominal pinhole at the FRAME resolution (SCALE× the config's under --hires)
        h, w = cfg.input_hw
        if args.hires:
            h, w = args.hires * h, args.hires * w
        camera = Camera(K=np.array([[w, 0, w / 2], [0, w, h / 2], [0, 0, 1]], np.float32),
                        dist=np.zeros(5, np.float32))
        print("WARNING: no --camera given; using nominal intrinsics")
    pipe = load_pipeline(cfg, args.deepc, args.refinenet, camera=camera,
                         rn_patch_size=args.rn_patch_size, rn_decode=args.rn_decode,
                         hires=args.hires, geom_decode=args.geom_decode,
                         geom_fill=args.geom_fill, device=args.device)
    pose_filter, stats = None, {"tracking": 0, "coasting": 0, "lost": 0}
    if args.smooth:
        # translation gate scaled to the board: 10 squares of motion per frame
        pose_filter = PoseFilter(gate_deg=args.smooth_gate_deg,
                                 gate_t=10.0 * cfg.square_len,
                                 max_coast=args.smooth_max_coast)
    if args.cv2_baseline:
        dictionary = B.get_aruco_dict(cfg.board_name)
        brd = B.get_board(cfg)
        params = B.create_detector_parameters()

    frames_out, poses, done = [], [], 0
    for frames in chunks:
        for j, (kp, valid, refined, ok, rvec, tvec) in enumerate(estimate(
                pipe, [frames], camera, args.ransac, pose_filter, stats)):
            poses.append((ok, rvec, tvec))
            if args.no_video:
                print(f"frame {done + j}: ok {ok} rvec {np.round(rvec.ravel(), 5).tolist()} "
                      f"tvec {np.round(tvec.ravel(), 5).tolist()}")
                continue
            img = frames[j] if frames[j].ndim == 3 else cv2.cvtColor(frames[j],
                                                                     cv2.COLOR_GRAY2BGR)
            vis = B.draw_keypoints_with_validity(img, kp, valid, draw_ids=True, radius=3,
                                                 color=(0, 0, 255))
            vis = B.draw_keypoints_with_validity(vis, refined, valid, radius=1,
                                                 color=(0, 255, 255))
            if ok:
                cv2.drawFrameAxes(vis, camera.K, camera.dist, rvec.reshape(3, 1),
                                  tvec.reshape(3, 1), 0.01, 2)
            if args.cv2_baseline:
                base, corners, ids = B.cv2_aruco_detect(img.copy(), dictionary, brd, params)
                pts = np.array(corners).reshape((-1, 2)) if len(corners) else np.zeros((0, 2))
                if pts.shape[0] >= 4 and ids is not None:
                    objp = B.get_board_object_points(brd)[ids.ravel()].reshape(-1, 3)
                    r_ok, r_cv, t_cv = cv2.solvePnP(objp.astype(np.float32),
                                                    pts.astype(np.float32), camera.K,
                                                    camera.dist)
                    if r_ok:
                        cv2.drawFrameAxes(base, camera.K, camera.dist, r_cv, t_cv, 0.01, 2)
                vis = np.hstack([vis, base])
            frames_out.append(vis)
        done += len(frames)
        print(f"{done}/{n_total} frames")
    if pose_filter is not None:
        print("pose filter: " + ", ".join(f"{k} {v}" for k, v in stats.items()))
    if not args.no_video:
        from deepcharuco_tpu_torch.utils import save_video

        save_video(frames_out, args.out or os.path.join(out_dir, "res.mp4"), fps=args.fps)
    return poses


if __name__ == "__main__":
    main()

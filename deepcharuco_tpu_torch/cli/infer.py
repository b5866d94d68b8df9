"""Inference CLI (``deepcharuco_tpu.cli.infer``): frames → detected corners.

Prints, per frame, the number of corners and the ``(x, y, id)`` rows of the
refined corners in the frame's own pixels. ``--out-dir`` draws the raw (red)
and refined (yellow) corners and ``--cv2-baseline`` puts the classical
cv2.aruco detection beside them; both need cv2, as do image files. Frames
may also come as a ``.npy``/``.npz`` file of uint8 frames, which needs no
cv2. :func:`infer_frames` is the core.

Run: ``python -m deepcharuco_tpu_torch.cli.infer frames.npy [--device cpu]``.
"""

from __future__ import annotations

import argparse
import os


def build_argparser():
    p = argparse.ArgumentParser(description="DeepCharuco inference")
    p.add_argument("images", nargs="+",
                   help="image files or globs (cv2), or .npy/.npz files of uint8 frames")
    p.add_argument("--config", default=None)
    p.add_argument("--deepc", default=None,
                   help="detector weights (.ckpt, .npz or a checkpoint directory)")
    p.add_argument("--refinenet", default=None, help="RefineNet weights")
    p.add_argument("--out-dir", default=None, help="write annotated images here (cv2)")
    p.add_argument("--cv2-baseline", action="store_true",
                   help="append classical cv2.aruco detection side by side (cv2)")
    p.add_argument("--hires", nargs="?", type=int, const=2, default=0, choices=[2, 4],
                   metavar="SCALE",
                   help="hi-res patch tap: frames at SCALE× the config resolution (bare "
                        "flag = 2); coordinates are printed in the input frame's pixels")
    p.add_argument("--rn-patch-size", type=int, choices=[24, 32], default=24,
                   help="RefineNet patch size (match the checkpoint)")
    p.add_argument("--rn-decode", choices=["hard", "soft", "offset", "avg"], default=None,
                   help="RefineNet decode (offset/avg need an offset-head checkpoint)")
    p.add_argument("--geom-decode", action="store_true",
                   help="geometry-consistent decode (ops/geom.py)")
    p.add_argument("--geom-fill", action="store_true",
                   help="with --geom-decode: predict undetected in-frame corners at their "
                        "homography-projected positions and refine them")
    p.add_argument("--batch", type=int, default=32,
                   help="frames per device batch (frames of one size)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain versions)")
    return p


def infer_frames(pipe, frames, batch: int = 32):
    """uint8 frames (N, H, W[, 3]) → per frame ``(rows, keypoints, valid,
    refined)``: ``rows`` the ``(x, y, id)`` array of the refined corners
    (``InferencePipeline.keypoint_array``) and the decode's arrays, all in
    the input frame's pixels."""
    out = []
    for i in range(0, len(frames), batch):
        kp, valid, refined = pipe.detect(frames[i:i + batch])
        kp, refined = pipe.input_coords(kp), pipe.input_coords(refined)
        out += [(pipe.keypoint_array(r, v), k, v, r) for k, v, r in zip(kp, valid, refined)]
    return out


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import numpy as np

    from deepcharuco_tpu_torch import board as B
    from deepcharuco_tpu_torch.cli import need_cv2, read_frames
    from deepcharuco_tpu_torch.configs import default_config, load_configuration
    from deepcharuco_tpu_torch.pipeline import load_pipeline

    if args.out_dir or args.cv2_baseline:
        cv2 = need_cv2("--out-dir" if args.out_dir else "--cv2-baseline")
    cfg = load_configuration(args.config) if args.config else default_config()
    pipe = load_pipeline(cfg, args.deepc, args.refinenet, rn_patch_size=args.rn_patch_size,
                         rn_decode=args.rn_decode, hires=args.hires,
                         geom_decode=args.geom_decode, geom_fill=args.geom_fill,
                         device=args.device)
    if args.deepc is None:
        print("WARNING: random detector weights (no --deepc given)")
    if args.cv2_baseline:
        dictionary = B.get_aruco_dict(cfg.board_name)
        brd = B.get_board(cfg)
        params = B.create_detector_parameters()

    named = read_frames(args.images)
    results = []
    i = 0
    while i < len(named):           # batches of consecutive frames of one shape
        j = i + 1
        while (j < len(named) and j - i < args.batch
               and named[j][1].shape == named[i][1].shape):
            j += 1
        results += infer_frames(pipe, np.stack([f for _, f in named[i:j]]), args.batch)
        i = j
    for (name, img), (rows, kp, valid, refined) in zip(named, results):
        print(f"{name}: {int(valid.sum())} corners")
        print(rows)
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            bgr = img if img.ndim == 3 else cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
            vis = B.draw_keypoints_with_validity(bgr, kp, valid, draw_ids=True, radius=3,
                                                 color=(0, 0, 255))
            vis = B.draw_keypoints_with_validity(vis, refined, valid, radius=1,
                                                 color=(0, 255, 255))
            if args.cv2_baseline:
                base, _, _ = B.cv2_aruco_detect(bgr.copy(), dictionary, brd, params)
                vis = np.hstack([vis, base])
            stem = os.path.basename(name).replace("[", "_").replace("]", "")
            if os.path.splitext(stem)[1].lower() not in (".png", ".jpg", ".jpeg", ".bmp"):
                stem += ".png"          # a frame of an array file
            out = os.path.join(args.out_dir, stem)
            cv2.imwrite(out, vis)
            print(f"wrote {out}")
    return results


if __name__ == "__main__":
    main()

"""Dataset / prediction grid viewer (``deepcharuco_tpu.cli.view``): a
contact-sheet PNG per page, written by the port's own encoder, with no cv2.

Modes
-----
- ``dataset``      — detector training stream: synthesized frames with the
  label-map corners drawn (green).
- ``refine``       — RefineNet stream: each training patch (nearest
  upsample to 64×64) beside its 64×64 target heatmap (viridis).
- ``predictions``  — the two-stage pipeline (``InferencePipeline.detect``,
  the decode kernel B1 on the card) on the validation stream, or on
  ``--images``, with the refined corners (magenta) over the label corners
  (green).

Unlike the JAX CLI, which forces its CPU backend, this one runs on the card
unless ``--device cpu`` is given. ``--show`` opens a window through cv2
when ``DISPLAY`` is set (any key = next page, q/ESC = quit); without a
display it is ignored, as in the JAX CLI.

Run: ``python -m deepcharuco_tpu_torch.cli.view --what predictions
[--device cpu]``.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def build_argparser():
    p = argparse.ArgumentParser(description="DeepCharuco grid viewer")
    p.add_argument("--what", choices=["dataset", "refine", "predictions"],
                   default="dataset")
    p.add_argument("--config", default=None)
    p.add_argument("--n", type=int, default=16, help="samples per page")
    p.add_argument("--pages", type=int, default=1)
    p.add_argument("--cols", type=int, default=4)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "dctpu_view"),
                   help="output prefix; writes <out>_p<k>.png per page")
    p.add_argument("--show", action="store_true",
                   help="also open an interactive window (needs DISPLAY and cv2)")
    p.add_argument("--validation", action="store_true",
                   help="seeded validation stream instead of train")
    p.add_argument("--deepc", default="artifacts/detector_devsynth.npz")
    p.add_argument("--refinenet", default="artifacts/refinenet_devsynth.npz")
    p.add_argument("--rn-patch-size", type=int, choices=[24, 32], default=24)
    p.add_argument("--rn-decode", choices=["soft", "offset", "avg"], default=None)
    p.add_argument("--geom-decode", action="store_true")
    p.add_argument("--geom-fill", action="store_true")
    p.add_argument("--images", default=None,
                   help="predictions: a directory of frames to run instead of the "
                        "synthetic validation stream (.png needs no cv2)")
    p.add_argument("--labels", default=None,
                   help="background corpus (captions json or directory); default = "
                        "procedural backgrounds")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain versions)")
    return p


def _tile(cells, cols, pad=2, bg=40):
    """hstack/vstack equal-size BGR cells into one grid image."""
    import numpy as np

    h, w = cells[0].shape[:2]
    rows = (len(cells) + cols - 1) // cols
    grid = np.full((rows * (h + pad) + pad, cols * (w + pad) + pad, 3), bg, np.uint8)
    for i, c in enumerate(cells):
        r, k = divmod(i, cols)
        y, x = pad + r * (h + pad), pad + k * (w + pad)
        grid[y:y + h, x:x + w] = c
    return grid


def _denorm(img_norm):
    """Invert normalize_image_host: (g-128)/255 → uint8 gray BGR."""
    import numpy as np

    g = np.clip(img_norm[..., 0] * 255.0 + 128.0, 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def _pages(args, make_cells):
    """Render pages, write PNGs, optionally show interactively."""
    from deepcharuco_tpu_torch.data import png

    show = args.show and "DISPLAY" in os.environ
    if show:
        from deepcharuco_tpu_torch.cli import need_cv2

        cv2 = need_cv2("--show")
    paths = []
    for page in range(args.pages):
        grid = _tile(make_cells(page), args.cols)
        path = f"{args.out}_p{page}.png"
        png.write_png(path, grid)
        paths.append(path)
        print("wrote", path)
        if show:
            cv2.imshow("deepcharuco_tpu_torch view", grid)
            if cv2.waitKey(0) & 0xFF in (ord("q"), 27):
                break
    if show:
        cv2.destroyAllWindows()
    elif args.show:
        print("(--show ignored: no DISPLAY in environment)")
    return paths


def _truth(sample, n_ids):
    """The label maps' keypoints and validity (``label_to_keypoints``)."""
    import numpy as np
    import torch

    from deepcharuco_tpu_torch.ops import label_to_keypoints

    kp, valid = label_to_keypoints(torch.from_numpy(np.asarray(sample["loc"])[None]),
                                   torch.from_numpy(np.asarray(sample["ids"])[None]), n_ids)
    return kp[0].numpy(), valid[0].numpy()


def main(argv=None):
    """Write the pages; returns their paths."""
    args = build_argparser().parse_args(argv)

    import numpy as np

    from deepcharuco_tpu_torch._device import resolve_device
    from deepcharuco_tpu_torch.board import draw_keypoints_with_validity
    from deepcharuco_tpu_torch.configs import default_config, load_configuration
    from deepcharuco_tpu_torch.data import CharucoDataset, RefineNetDataset, cvnp

    device = resolve_device(args.device)
    cfg = load_configuration(args.config) if args.config else default_config()

    if args.what == "dataset":
        ds = CharucoDataset(cfg, labels=args.labels, validation=args.validation)

        def cells(page):
            out = []
            for i in range(args.n):
                s = ds[page * args.n + i]
                kp, valid = _truth(s, cfg.n_ids)
                out.append(draw_keypoints_with_validity(_denorm(s["image"]), kp, valid,
                                                        color=(0, 255, 0)))
            return out

        return _pages(args, cells)

    if args.what == "refine":
        ds = RefineNetDataset(cfg, labels=args.labels, validation=args.validation)

        def cells(page):
            out = []
            i = page * args.n
            while len(out) < args.n:
                s = ds[i]
                i += 1
                for patch, heat in zip(s["patches"], s["heatmaps"]):
                    big = cvnp.resize_nearest(_denorm(patch), (64, 64))
                    hm = np.clip(heat[..., 0] * 255.0, 0, 255).astype(np.uint8)
                    out.append(np.concatenate([big, cvnp.apply_colormap(hm, "viridis")],
                                              axis=1))
                    if len(out) == args.n:
                        break
            return out

        return _pages(args, cells)

    from deepcharuco_tpu_torch.pipeline import load_pipeline

    pipe = load_pipeline(cfg, args.deepc, args.refinenet, rn_patch_size=args.rn_patch_size,
                         rn_decode=args.rn_decode, geom_decode=args.geom_decode,
                         geom_fill=args.geom_fill, device=device)

    if args.images:
        from deepcharuco_tpu_torch.data import DirectoryImageSource

        src = DirectoryImageSource(args.images)
        h, w = cfg.input_hw

        def frame_and_truth(idx):
            img = src.get(idx)
            if img.shape[:2] != (h, w):
                img = cvnp.resize_linear_u8(img, (h, w))
            return img, None
    else:
        ds = CharucoDataset(cfg, labels=args.labels, validation=True)

        def frame_and_truth(idx):
            s = ds[idx]
            return _denorm(s["image"]), _truth(s, cfg.n_ids)

    def cells(page):
        imgs, truths = [], []
        for i in range(args.n):
            img, truth = frame_and_truth(page * args.n + i)
            imgs.append(img)
            truths.append(truth)
        _, valid, refined = pipe.detect(np.stack(imgs))
        out = []
        for img, truth, v, r in zip(imgs, truths, valid, refined):
            if truth is not None:
                img = draw_keypoints_with_validity(img, truth[0], truth[1], color=(0, 255, 0))
            out.append(draw_keypoints_with_validity(img, r, v, color=(255, 0, 255)))
        return out

    return _pages(args, cells)


if __name__ == "__main__":
    main()

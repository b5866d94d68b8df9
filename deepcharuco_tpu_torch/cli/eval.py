"""Corner-accuracy evaluation (``deepcharuco_tpu.cli.eval``).

Runs the seeded validation stream of on-card synthetic boards
(``data.DeviceSynthesizer``, batch j from ``torch.Generator`` seed j; the
JAX package draws from its own keys, so the samples differ) through float32
models and compares the raw and the refined corners with the truth: the
label maps (the reference's semantics) or, with ``--truth subpixel``, the
exact warped corner positions. The decode is the decode kernel on the card.
:func:`make_forward` builds the forward, :func:`synth_batches` the stream,
:func:`evaluate` the figures. Not ported: the host validation stream
(``--source host``, ``--images``, ``--labels``; ROADMAP.md §A, A4).

Run: ``python -m deepcharuco_tpu_torch.cli.eval [--device cpu]``.
"""

from __future__ import annotations

import argparse


def build_argparser():
    p = argparse.ArgumentParser(description="Corner-accuracy evaluation")
    p.add_argument("--config", default=None)
    p.add_argument("--deepc", default=None)
    p.add_argument("--refinenet", default=None)
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--source", choices=["host", "device"], default="device",
                   help="validation stream: device (on-card synthesis) or host (not ported)")
    p.add_argument("--px-margin", type=float, default=3.0)
    p.add_argument("--min-margin", type=float, default=None,
                   help="id-vs-dustbin logit margin filter (decode knob)")
    p.add_argument("--truth", choices=["labels", "subpixel"], default="labels",
                   help="reference corners: quantized label maps or exact sub-pixel "
                        "positions (device source)")
    p.add_argument("--rn-offset", action="store_true",
                   help="decode via the offset-regression branch (offset-head checkpoint)")
    p.add_argument("--rn-avg", action="store_true",
                   help="average the soft-argmax and the offset-branch decodes "
                        "(offset-head checkpoint; overrides --rn-offset)")
    p.add_argument("--soft-argmax", action="store_true",
                   help="decode the refine heatmap with soft-argmax instead of hard argmax")
    p.add_argument("--rn-upsample", choices=["nearest", "bilinear"], default="nearest")
    p.add_argument("--rn-patch-size", type=int, choices=[24, 32], default=24)
    p.add_argument("--images", default=None, help="host stream images (not ported)")
    p.add_argument("--labels", default=None, help="host stream labels (not ported)")
    p.add_argument("--frontal", action="store_true",
                   help="device source: axis-snapped frontal geometry, standard photometry")
    p.add_argument("--scale", type=float, default=None,
                   help="device source: pin the board scale")
    p.add_argument("--hires", nargs="?", type=int, const=2, default=0, choices=[2, 4],
                   metavar="SCALE",
                   help="hi-res patch tap: synthesize SCALE×-resolution frames; errors in "
                        "base-config px (device + subpixel only)")
    p.add_argument("--geom-decode", action="store_true",
                   help="geometry-consistent decode (ops/geom.py)")
    p.add_argument("--geom-fill", action="store_true",
                   help="with --geom-decode: fill undetected in-frame ids before refinement")
    p.add_argument("--geom-ransac", type=int, default=32,
                   help="with --geom-decode: RANSAC seed subsets (0 = least squares)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain versions)")
    return p


def refine_mode(args) -> str:
    return ("avg" if args.rn_avg else "offset" if args.rn_offset
            else "soft" if args.soft_argmax else "hard")


def make_forward(args, cfg, device):
    """The float32 forward of the evaluation: normalized gray images
    (N, H, W, 1) on ``device`` → (keypoints, valid, refined) tensors
    (``--hires``: the tap, in base-config pixels)."""
    import torch

    from deepcharuco_tpu_torch.board import inner_corner_object_points
    from deepcharuco_tpu_torch.models import RefineNet
    from deepcharuco_tpu_torch.pipeline import (_apply_refiner, load_detector_any,
                                                load_model_variables,
                                                two_stage_forward_hires)
    from deepcharuco_tpu_torch.ops import (extract_patches, fill_from_homography,
                                           pred_to_keypoints, pred_to_keypoints_geom)
    from deepcharuco_tpu_torch.weights import load_state, refinenet_state_dict

    mode = refine_mode(args)
    det = load_detector_any(args.deepc, cfg.n_ids, compute_dtype=torch.float32,
                            device=device)
    offset = mode in ("offset", "avg")
    make_rn = lambda: RefineNet(torch.float32, upsample=args.rn_upsample,
                                patch_size=args.rn_patch_size, offset_head=offset)
    if args.refinenet is None:      # seeded weights of this evaluation's variant
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            rn = make_rn()
    else:
        sd = refinenet_state_dict(load_model_variables(args.refinenet, "refinenet"))
        if not offset:              # an offset branch in the weights stays unused
            sd = {k: v for k, v in sd.items()
                  if not k.startswith(("convOa.", "denseOa.", "denseOb."))}
        rn = load_state(make_rn(), sd)
    rn = rn.to(device).eval()
    board_xy = None
    if args.geom_decode:
        board_xy = torch.as_tensor(inner_corner_object_points(
            cfg.row_count, cfg.col_count, cfg.square_len)[:, :2]).to(device)

    @torch.inference_mode()
    def forward(images):
        if args.hires:
            return two_stage_forward_hires(det, rn, images, cfg.n_ids,
                                           min_margin=args.min_margin, rn_decode=mode,
                                           geom_board_xy=board_xy, geom_fill=args.geom_fill,
                                           geom_ransac=args.geom_ransac, scale=args.hires,
                                           device=device)
        out = det(images)
        if board_xy is not None:
            kp, valid = pred_to_keypoints_geom(out["loc"], out["ids"], cfg.n_ids, board_xy,
                                               min_margin=args.min_margin,
                                               ransac_subsets=args.geom_ransac)
            if args.geom_fill:
                kp, valid, _ = fill_from_homography(kp, valid, board_xy, cfg.input_hw)
        else:
            kp, valid = pred_to_keypoints(out["loc"], out["ids"], cfg.n_ids,
                                          min_margin=args.min_margin)
        patches = extract_patches(images, kp, patch_size=args.rn_patch_size)
        return kp, valid, _apply_refiner(rn, patches, kp, mode)

    return forward


def synth_batches(args, cfg, device, bs: int = 16):
    """The device validation stream: ``max(1, samples // bs)`` batches of
    (images, truth), truth ``(kpts, visible)`` under ``--truth subpixel``
    (``--hires``: in base-config pixels) else the label maps ``(loc, ids)``."""
    import torch

    from deepcharuco_tpu_torch.configs import scaled_config
    from deepcharuco_tpu_torch.data import DeviceSynthesizer

    sr = (args.scale, args.scale + 1e-4) if args.scale else None
    synth = DeviceSynthesizer(scaled_config(cfg, args.hires) if args.hires else cfg,
                              negative_p=0.0 if args.frontal else 0.05,
                              axis_snap_p=1.0 if args.frontal else 0.0, scale_range=sr,
                              device=device)
    if args.frontal:
        synth.translate_frac = (-0.1, 0.1)      # keep the board in frame
    for j in range(max(1, args.samples // bs)):
        gen = torch.Generator(device=device).manual_seed(j)
        images, loc, ids, kpts, visible = synth.render_full(synth.draw(gen, bs))
        if args.truth == "subpixel":
            if args.hires:
                s = args.hires      # x_hi = s·x_lo + (s−1)/2
                kpts = (kpts - (s - 1) * 0.5) / s
            yield images, (kpts, visible)
        else:
            yield images, (loc, ids)


def evaluate(forward, batches, n_ids: int, px_margin: float = 3.0,
             truth: str = "labels") -> dict:
    """Raw and refined corner errors of ``forward`` over ``batches`` of
    (images, truth): ``n_target``, ``n_pred``, ``n_matched`` (raw error <
    ``px_margin``), ``recall``, ``raw_mean``/``refined_mean`` (None without
    a matched corner) and the medians and maxima."""
    import numpy as np
    import torch

    from deepcharuco_tpu_torch.ops import label_to_keypoints

    raw_errs, ref_errs = [], []
    n_matched = n_target = n_pred = n_samples = 0
    for images, t in batches:
        kp, valid, refined = (x.cpu().numpy() for x in forward(images))
        if truth == "subpixel":
            kp_t, valid_t = t
        else:
            kp_t, valid_t = label_to_keypoints(torch.as_tensor(t[0]), torch.as_tensor(t[1]),
                                               n_ids)
        kp_t, valid_t = np.asarray(torch.as_tensor(kp_t).cpu()), np.asarray(
            torch.as_tensor(valid_t).cpu())
        both = valid & valid_t
        d_raw = np.linalg.norm(kp - kp_t, axis=-1)[both]
        raw_errs.append(d_raw)
        ref_errs.append(np.linalg.norm(refined - kp_t, axis=-1)[both])
        n_matched += int((d_raw < px_margin).sum())
        n_target += int(valid_t.sum())
        n_pred += int(valid.sum())
        n_samples += len(kp)
    raw = np.concatenate(raw_errs) if raw_errs else np.zeros(0)
    ref = np.concatenate(ref_errs) if ref_errs else np.zeros(0)
    stat = lambda a, f: float(f(a)) if a.size else None
    return {"samples": n_samples, "n_target": n_target, "n_pred": n_pred,
            "n_matched": n_matched, "recall": n_matched / max(1, n_target),
            "raw_mean": stat(raw, np.mean), "raw_median": stat(raw, np.median),
            "raw_max": stat(raw, np.max), "refined_mean": stat(ref, np.mean),
            "refined_median": stat(ref, np.median), "refined_max": stat(ref, np.max)}


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from deepcharuco_tpu_torch._device import resolve_device
    from deepcharuco_tpu_torch.cli import not_ported
    from deepcharuco_tpu_torch.configs import default_config, load_configuration

    if args.source == "host" or args.images or args.labels:
        not_ported("the host validation stream (--source host, --images, --labels)", "A4")
    if args.geom_fill and not args.geom_decode:
        raise SystemExit("--geom-fill requires --geom-decode")
    if args.hires and args.truth != "subpixel":
        raise SystemExit("--hires requires --source device --truth subpixel")
    dev = resolve_device(args.device)
    cfg = load_configuration(args.config) if args.config else default_config()
    if args.deepc is None:
        print("WARNING: random detector weights")
    res = evaluate(make_forward(args, cfg, dev), synth_batches(args, cfg, dev), cfg.n_ids,
                   args.px_margin, args.truth)
    print(f"samples: {res['samples']}  target corners: {res['n_target']}  "
          f"predicted: {res['n_pred']}  matched(<{args.px_margin}px): {res['n_matched']}")
    if res["raw_mean"] is not None:
        print(f"raw     corner error: mean {res['raw_mean']:.3f}px  "
              f"median {res['raw_median']:.3f}px  max {res['raw_max']:.2f}px")
        print(f"refined corner error: mean {res['refined_mean']:.3f}px  "
              f"median {res['refined_median']:.3f}px  max {res['refined_max']:.2f}px")
        print(f"recall@{args.px_margin}px: {res['recall']:.3f}")
    return res


if __name__ == "__main__":
    main()

"""Quantize a detector into the int8 serving artifact
(``scripts/quantize_detector.py``), on the card unless ``--device cpu``.

Post-training quantization (:mod:`deepcharuco_tpu_torch.models.quant`):
BatchNorm folded, weights quantized per output channel, activation scales
calibrated on ``--calib-samples`` boards synthesised on the card
(``DeviceSynthesizer``, ``torch.Generator`` seeded ``--seed``), the tree
written as the int8 npz that ``load_pipeline`` recognises. Then the float32
and int8 decodes are compared on ``--eval-samples`` further boards (drawn
from the same generator): detections, position agreement and recall at
3 px against the labels.

Run: ``python -m deepcharuco_tpu_torch.cli.quantize <detector> --out <int8.npz>
[--device cpu]``.
"""

from __future__ import annotations

import argparse
import os


def build_argparser():
    p = argparse.ArgumentParser(description="Quantize a detector to the int8 artifact")
    p.add_argument("detector", help="detector weights (.npz, .ckpt or a trainer directory)")
    p.add_argument("--out", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--calib-samples", type=int, default=64)
    p.add_argument("--eval-samples", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain versions)")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import numpy as np
    import torch

    from deepcharuco_tpu_torch._device import resolve_device
    from deepcharuco_tpu_torch.configs import default_config, load_configuration
    from deepcharuco_tpu_torch.data import DeviceSynthesizer
    from deepcharuco_tpu_torch.models import Detector
    from deepcharuco_tpu_torch.models.quant import (QuantDetector, qvars_to_npz,
                                                    quantize_detector)
    from deepcharuco_tpu_torch.ops import label_to_keypoints, pred_to_keypoints
    from deepcharuco_tpu_torch.pipeline import load_model_variables
    from deepcharuco_tpu_torch.weights import detector_state_dict, load_state

    dev = resolve_device(args.device)
    cfg = load_configuration(args.config) if args.config else default_config()
    dv = load_model_variables(args.detector, "detector", cfg.n_ids)
    det = load_state(Detector(n_ids=cfg.n_ids, dtype=torch.float32),
                     detector_state_dict(dv)).to(dev).eval()
    synth = DeviceSynthesizer(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    images, _, _ = synth.batch(gen, args.calib_samples)
    qv = quantize_detector(det, dv, images, device=dev)
    qvars_to_npz(args.out, qv)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1024:.0f} KiB)")
    if args.eval_samples <= 0:
        return None

    images, loc, ids = synth.batch(gen, args.eval_samples)
    qdet = QuantDetector(qv, cfg.n_ids).to(dev).eval()
    with torch.inference_mode():
        out_f, out_q = det(images), qdet(images)
        kp_f, v_f = pred_to_keypoints(out_f["loc"], out_f["ids"], cfg.n_ids)
        kp_q, v_q = pred_to_keypoints(out_q["loc"], out_q["ids"], cfg.n_ids)
        kp_t, v_t = label_to_keypoints(loc, ids, cfg.n_ids)
    kp_f, v_f, kp_q, v_q, kp_t, v_t = (x.cpu().numpy() for x in (kp_f, v_f, kp_q, v_q,
                                                                  kp_t, v_t))
    both = v_f & v_q
    d = np.linalg.norm(kp_f - kp_q, axis=-1)[both]
    print(f"detections f32={int(v_f.sum())} int8={int(v_q.sum())} both={int(both.sum())}")
    if d.size:
        print(f"position agreement: mean {d.mean():.4f} px, max {d.max():.3f} px, "
              f"identical {float((d == 0).mean()):.3f}")
    recall = {}
    for name, kp, v in (("f32", kp_f, v_f), ("int8", kp_q, v_q)):
        err = np.linalg.norm(kp - kp_t, axis=-1)
        recall[name] = float(((err <= 3.0) & v & v_t).sum() / max(v_t.sum(), 1))
        print(f"{name:4s} recall@3px = {recall[name]:.4f}")
    return {"detections_f32": int(v_f.sum()), "detections_int8": int(v_q.sum()),
            "both": int(both.sum()), "identical": float((d == 0).mean()) if d.size else None,
            "recall": recall}


if __name__ == "__main__":
    main()

"""RefineNet training on the card (``deepcharuco_tpu.cli.train_refinenet``).

The ``--device-synth`` path: patches are synthesised on the card from a
``torch.Generator`` seeded 4321 (the JAX trainer's feed key), either
rendered directly (``DeviceRefineSynthesizer``) or, with
``--frame-patches``, cut from whole synthetic frames by the inference
gather (``FramePatchSynthesizer``, at ``--frame-scale`` × the config's
resolution). Every ``--eval-every`` dispatches: ``--eval-batches`` batches
of 32 patches, batch j from seed 888 + j, the heatmap MSE and
``refinenet_metric`` logged, a top-k checkpoint written under the global
step. ``--fused-steps K`` runs K steps per dispatch.

Not ported (``NotImplementedError``): training without ``--device-synth``
(the host ``RefineNetDataset``, ROADMAP.md §A, A4).

Run: ``python -m deepcharuco_tpu_torch.cli.train_refinenet --device-synth``.
"""

from __future__ import annotations

import argparse
import time

from deepcharuco_tpu_torch.cli import not_ported


def build_argparser():
    p = argparse.ArgumentParser(description="Train RefineNet on the card")
    p.add_argument("--config", default=None)
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--eval-every", type=int, default=500)
    p.add_argument("--eval-batches", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=None,
                   help="patches per step (override bs_train_rn)")
    p.add_argument("--total", type=int, default=8, help="patches per image (host pipeline)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--logdir", default="tb_logs/refinenet")
    p.add_argument("--ckpt-dir", default="checkpoints/refinenet")
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--init-npz", default=None,
                   help="initialize from a shipped .npz (shared layers; fresh optimizer)")
    p.add_argument("--images", default=None)
    p.add_argument("--labels", default=None)
    p.add_argument("--device-synth", action="store_true",
                   help="synthesise the patches on the card (the ported path)")
    p.add_argument("--frame-patches", action="store_true",
                   help="cut the patches from whole synthetic frames by the "
                        "inference gather")
    p.add_argument("--rounded-targets", action="store_true",
                   help="targets on the 1/8-px grid (reference parity)")
    p.add_argument("--patch-size", type=int, choices=[24, 32], default=24)
    p.add_argument("--upsample", choices=["nearest", "bilinear"], default="nearest")
    p.add_argument("--offset-weight", type=float, default=0.0,
                   help="weight of the offset branch's loss (adds the branch); 0 = off")
    p.add_argument("--coord-weight", type=float, default=0.0,
                   help="weight of the soft-argmax coordinate loss; 0 = MSE only")
    p.add_argument("--perspective-p", type=float, default=0.0)
    p.add_argument("--fused-steps", type=int, default=1)
    p.add_argument("--frame-scale", type=int, default=1,
                   help="with --frame-patches: frames at N x the config's resolution")
    p.add_argument("--jitter-px", type=float, default=None,
                   help="patch-center jitter in source-frame px (default 3 at "
                        "frame-scale 1, else 2 x frame-scale)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain versions)")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import torch

    from deepcharuco_tpu_torch._device import resolve_device
    from deepcharuco_tpu_torch.configs import (default_config, load_configuration,
                                               scaled_config)
    from deepcharuco_tpu_torch.data import DeviceRefineSynthesizer, FramePatchSynthesizer
    from deepcharuco_tpu_torch.models import RefineNet
    from deepcharuco_tpu_torch.parallel import synth_scan_program
    from deepcharuco_tpu_torch.pipeline import merge_variables
    from deepcharuco_tpu_torch.train import (create_refinenet_state, flax_init_,
                                             make_refinenet_eval_step,
                                             make_refinenet_train_step, state_variables)
    from deepcharuco_tpu_torch.train.checkpoints import (CheckpointManager,
                                                         optimizer_arrays, resume)
    from deepcharuco_tpu_torch.train.logging import ScalarLogger
    from deepcharuco_tpu_torch.train.metrics import MeanAccumulator, refinenet_metric
    from deepcharuco_tpu_torch.weights import (load_state, refinenet_state_dict,
                                               variables_from_npz)

    dev = resolve_device(args.device)
    if not args.device_synth:
        not_ported("training RefineNet without --device-synth (the host data pipeline)", "A4")
    if args.frame_scale > 1 and not args.frame_patches:
        raise SystemExit("--frame-scale needs --frame-patches (the direct patch "
                         "sampler has no frame to scale)")
    cfg = load_configuration(args.config) if args.config else default_config()
    bs = args.batch_size or cfg.bs_train_rn

    rn = flax_init_(RefineNet(torch.float32, upsample=args.upsample,
                              patch_size=args.patch_size,
                              offset_head=args.offset_weight > 0.0)).to(dev)
    state = create_refinenet_state(rn, args.lr)
    if args.init_npz:
        merged, loaded, skipped = merge_variables(state_variables(state),
                                                  variables_from_npz(args.init_npz))
        load_state(rn, refinenet_state_dict(merged))
        print(f"initialized {len(loaded)} arrays from {args.init_npz}"
              + (f" ({len(skipped)} kept fresh/skipped)" if skipped else ""))
    ckpts = CheckpointManager(args.ckpt_dir, top_k=args.top_k)
    if args.resume:
        print(resume(state, ckpts, args.resume))

    cont = not args.rounded_targets
    if args.frame_patches:
        synth_cfg = scaled_config(cfg, args.frame_scale) if args.frame_scale > 1 else cfg
        jitter = (args.jitter_px if args.jitter_px is not None
                  else 3.0 if args.frame_scale == 1 else 2.0 * args.frame_scale)
        synth = FramePatchSynthesizer(synth_cfg, continuous_targets=cont,
                                      patch_size=args.patch_size,
                                      perspective_p=args.perspective_p, jitter_px=jitter,
                                      device=dev)
    else:
        synth = DeviceRefineSynthesizer(cfg, continuous_targets=cont,
                                        patch_size=args.patch_size, device=dev)
    program = synth_scan_program(
        make_refinenet_train_step(coord_weight=args.coord_weight,
                                  offset_weight=args.offset_weight),
        lambda g: synth.batch(g, bs), fused_steps=args.fused_steps)
    eval_fn = make_refinenet_eval_step(offset_weight=args.offset_weight)
    feed = torch.Generator(device=dev).manual_seed(4321)
    print(f"on-card patch synthesis: {bs} patches per step, device {dev}")

    logger = ScalarLogger(args.logdir)
    acc = MeanAccumulator()
    t0 = time.time()
    for i in range(args.steps):
        state, aux = program(state, feed)
        acc.update(train_refinenet_loss=aux["loss"])
        if (i + 1) % args.eval_every == 0:
            train_scalars = acc.compute()
            acc.reset()
            ev = MeanAccumulator()
            for j in range(args.eval_batches):
                p, h = synth.batch(torch.Generator(device=dev).manual_seed(888 + j), 32)
                aux_v, heat_hat = eval_fn(state, p, h)
                ev.update(val_refinenet_loss=aux_v["loss"],
                          val_dist_refinenet_pixels=refinenet_metric(heat_hat, h))
            val_scalars = ev.compute()
            # the window runs to here: the next one counts this log and save
            sps = args.eval_every / (time.time() - t0)
            t0 = time.time()
            logger.log(i + 1, {**train_scalars, **val_scalars, "steps_per_sec": sps})
            print(f"step {i+1}: loss={train_scalars['train_refinenet_loss']:.5f} "
                  f"val={val_scalars['val_refinenet_loss']:.5f} "
                  f"val_dist={val_scalars['val_dist_refinenet_pixels']:.2f}px(8x) "
                  f"({sps:.1f} steps/s)", flush=True)
            ckpts.save(f"step_{state.step:07d}", state_variables(state),
                       metric=val_scalars["val_refinenet_loss"],
                       optimizer=optimizer_arrays(state))
    logger.close()
    print(f"best checkpoint: {ckpts.best_checkpoint()}")


if __name__ == "__main__":
    main()

"""Detector training on the card (``deepcharuco_tpu.cli.train``).

The ``--device-synth`` path: each batch is synthesised on the card from a
``torch.Generator`` (seeded 1234, the JAX trainer's feed key), the train
step runs beside it, and the host only loops. Every ``--eval-every``
dispatches the model is scored on ``--eval-batches`` batches of 16, batch j
drawn from seed 777 + j, with ``train.metrics.detector_metrics`` (the decode
kernel on the card), the scalars logged and a top-k checkpoint written, named
by the global step. A non-finite loss stops the run (checked every 100
dispatches). ``--fused-steps K`` runs K synthesis + train steps per
dispatch, as the JAX trainer's scan does: ``--steps`` counts dispatches.

Not ported (``NotImplementedError``): the host data pipeline (training
without ``--device-synth``, ``--mixed-host-every``, ``--eval-host-batches``),
the background bank builder (``--bg-bank``) and more than one card
(``--data-parallel`` with several cards, ``--mesh-spatial``).
``--data-parallel`` on one card does nothing, as in the JAX trainer.

Run: ``python -m deepcharuco_tpu_torch.cli.train --device-synth [--device cpu]``.
"""

from __future__ import annotations

import argparse
import math
import time

from deepcharuco_tpu_torch.cli import not_ported


def build_argparser():
    p = argparse.ArgumentParser(description="Train the DeepCharuco detector on the card")
    p.add_argument("--config", default=None, help="YAML config (reference schema)")
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--eval-every", type=int, default=500)
    p.add_argument("--eval-batches", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=None, help="override bs_train")
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--logdir", default="tb_logs/deepcharuco")
    p.add_argument("--ckpt-dir", default="checkpoints/deepcharuco")
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--num-workers", type=int, default=None,
                   help="host pipeline workers (unused on the --device-synth path)")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the batch over the cards (one card: nothing to do)")
    p.add_argument("--mesh-spatial", type=int, default=1)
    p.add_argument("--device-synth", action="store_true",
                   help="synthesise the training data on the card (the ported path)")
    p.add_argument("--fused-steps", type=int, default=1,
                   help="synthesis + train steps per dispatch")
    p.add_argument("--resume", default=None, help="checkpoint name to resume from")
    p.add_argument("--init-npz", default=None,
                   help="initialize the weights from a shipped .npz (fresh optimizer)")
    p.add_argument("--images", default=None, help="background images (host pipeline)")
    p.add_argument("--labels", default=None, help="COCO captions json (host pipeline)")
    p.add_argument("--conf-weight", type=float, default=0.0,
                   help="weight of the ids-head margin-calibration loss (0 = CE only)")
    p.add_argument("--conf-margin", type=float, default=4.0)
    p.add_argument("--conf-topk", type=int, default=0,
                   help="hinge each image's K worst background cells outside the "
                        "corners' 3x3 neighbourhood; 0 = off")
    p.add_argument("--conf-fg-topk", type=int, default=0,
                   help="hinge each image's K worst corner cells; 0 = off")
    p.add_argument("--axis-snap-p", type=float, default=0.0)
    p.add_argument("--perspective-p", type=float, default=0.0)
    p.add_argument("--scale-max", type=float, default=None)
    p.add_argument("--low-gain-p", type=float, default=0.0)
    p.add_argument("--low-gain-min", type=float, default=0.08)
    p.add_argument("--bg-bank", type=int, default=0)
    p.add_argument("--bg-bank-p", type=float, default=0.5)
    p.add_argument("--mixed-host-every", type=int, default=0)
    p.add_argument("--eval-host-batches", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain versions)")
    return p


def refuse_unported(args, n_cards: int) -> None:
    if not args.device_synth:
        not_ported("training without --device-synth (the host data pipeline)")
    if args.mixed_host_every > 0:
        not_ported("--mixed-host-every (the host data pipeline)")
    if args.eval_host_batches > 0:
        not_ported("--eval-host-batches (the host data pipeline)")
    if args.bg_bank > 0:
        not_ported("--bg-bank (the background bank builder)")
    if args.mesh_spatial > 1 or (args.data_parallel and n_cards > 1):
        not_ported("training across several cards (DDP)")


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import torch

    from deepcharuco_tpu_torch._device import resolve_device
    from deepcharuco_tpu_torch.configs import default_config, load_configuration
    from deepcharuco_tpu_torch.data import DeviceSynthesizer
    from deepcharuco_tpu_torch.models import Detector
    from deepcharuco_tpu_torch.parallel import synth_scan_program
    from deepcharuco_tpu_torch.train import (create_detector_state, flax_init_,
                                             make_detector_eval_step,
                                             make_detector_train_step, state_variables)
    from deepcharuco_tpu_torch.train.checkpoints import (CheckpointManager,
                                                         optimizer_arrays, resume)
    from deepcharuco_tpu_torch.train.logging import ScalarLogger
    from deepcharuco_tpu_torch.train.metrics import MeanAccumulator, detector_metrics
    from deepcharuco_tpu_torch.weights import (detector_state_dict, load_state,
                                               variables_from_npz)

    dev = resolve_device(args.device)
    refuse_unported(args, torch.cuda.device_count() if dev.type == "cuda" else 1)
    cfg = load_configuration(args.config) if args.config else default_config()
    bs = args.batch_size or cfg.bs_train

    det = flax_init_(Detector(n_ids=cfg.n_ids, dtype=torch.float32)).to(dev)
    state = create_detector_state(det, args.lr)
    if args.init_npz:
        load_state(det, detector_state_dict(variables_from_npz(args.init_npz)))
        print(f"initialized weights from {args.init_npz}")
    ckpts = CheckpointManager(args.ckpt_dir, top_k=args.top_k)
    if args.resume:
        print(resume(state, ckpts, args.resume))

    synth = DeviceSynthesizer(
        cfg, axis_snap_p=args.axis_snap_p,
        scale_range=((0.25, args.scale_max) if args.scale_max else None),
        perspective_p=args.perspective_p, low_gain_p=args.low_gain_p,
        low_gain_min=args.low_gain_min, device=dev)
    K = max(1, args.fused_steps)
    program = synth_scan_program(
        make_detector_train_step(conf_weight=args.conf_weight, conf_margin=args.conf_margin,
                                 conf_topk=args.conf_topk, conf_fg_topk=args.conf_fg_topk),
        lambda g: synth.batch(g, bs), fused_steps=K)
    eval_fn = make_detector_eval_step()
    feed = torch.Generator(device=dev).manual_seed(1234)
    print(f"on-card synthesis: batch {bs}, {K} step(s) per dispatch, device {dev}")

    logger = ScalarLogger(args.logdir)
    acc = MeanAccumulator()
    t0 = time.time()
    for i in range(args.steps):
        state, aux = program(state, feed)
        acc.update(train_loss=aux["loss"], train_loss_loc=aux["loss_loc"],
                   train_loss_ids=aux["loss_ids"])
        if (i + 1) % 100 == 0 and not math.isfinite(float(aux["loss"])):
            print(f"FATAL: non-finite loss at step {i+1}; aborting", flush=True)
            break

        if (i + 1) % args.eval_every == 0:
            train_scalars = acc.compute()
            acc.reset()
            ev = MeanAccumulator()
            for j in range(args.eval_batches):
                vi, vl, vd = synth.batch(torch.Generator(device=dev).manual_seed(777 + j), 16)
                aux_v, out = eval_fn(state, vi, vl, vd)
                m = detector_metrics(out["loc"], out["ids"], vl, vd, cfg.n_ids)
                ev.update(val_loss=aux_v["loss"], val_loss_loc=aux_v["loss_loc"],
                          val_loss_ids=aux_v["loss_ids"], val_l2_pixels=m["l2_pixels"],
                          val_match_ratio=m["match_ratio"], val_n_pred=m["n_pred"],
                          val_n_target=m["n_target"])
            val_scalars = ev.compute()
            sps = args.eval_every / (time.time() - t0)
            logger.log(i + 1, {**train_scalars, **val_scalars, "steps_per_sec": sps})
            print(f"step {i+1}: train_loss={train_scalars['train_loss']:.4f} "
                  f"val_loss={val_scalars['val_loss']:.4f} "
                  f"val_l2={val_scalars['val_l2_pixels']:.2f}px "
                  f"match={val_scalars['val_match_ratio']:.3f} "
                  f"pred/tgt={val_scalars['val_n_pred']:.1f}/{val_scalars['val_n_target']:.1f} "
                  f"({sps:.1f} steps/s)", flush=True)
            # named by the global optimizer step, which a resume restores
            ckpts.save(f"step_{state.step:07d}", state_variables(state),
                       metric=val_scalars["val_loss"], optimizer=optimizer_arrays(state))
            t0 = time.time()
    logger.close()
    print(f"best checkpoint: {ckpts.best_checkpoint()}")


if __name__ == "__main__":
    main()

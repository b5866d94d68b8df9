"""Detector training (``deepcharuco_tpu.cli.train``), on the card unless
``--device cpu``.

Two feeds, as in the JAX trainer:

- ``--device-synth``: each batch is synthesised on the card from a
  ``torch.Generator`` (seeded 1234, the JAX trainer's feed key) beside the
  train step; ``--fused-steps K`` runs K synthesis + train steps per
  dispatch (``--steps`` counts dispatches). ``--bg-bank N`` builds N gray
  backgrounds on the host once (from ``--images``/``--labels``, else the
  procedural source) and composites boards on crops of them on the card with
  probability ``--bg-bank-p``. ``--mixed-host-every N`` replaces every Nth
  dispatch by one step on a host batch (the mixed diet), and
  ``--eval-host-batches N`` scores N host validation batches of 16 at each
  eval (``val_host_*`` scalars).
- Without it, the host pipeline: ``CharucoDataset`` in
  ``--num-workers`` threads (``BatchLoader``, seed 0), copied to the card
  ahead of the step (``device_prefetch``); eval batches come from the
  seeded validation stream (batch j: samples 16j … 16j + 15).

Every ``--eval-every`` dispatches the model is scored on ``--eval-batches``
batches of 16 (on-card: batch j drawn from seed 777 + j) with
``train.metrics.detector_metrics`` (the decode kernel on the card), the
scalars logged and a top-k checkpoint written, named by the global step. A
non-finite loss stops the run (checked every 100 dispatches).

Several cards: under ``torchrun`` with more than one rank,
``--data-parallel`` trains over a ('data', 'spatial') mesh of the ranks
(``parallel.mesh``; ``--mesh-spatial S`` ranks split each image's height,
and S must divide the rank count). Every rank draws the same global batch
and trains on its share; the mixed diet's and the host feed's batches are
shared out the same way, each share built on the first rank of its spatial
group and broadcast to the others (``host_batches``). Rank 0 alone evaluates, logs and writes
checkpoints while the others wait; ``--resume`` and ``--init-npz`` load on
every rank. With one rank both flags do nothing, as in the JAX trainer.

Run: ``python -m deepcharuco_tpu_torch.cli.train [--device-synth] [--device cpu]``,
or ``python -m torch.distributed.run --nproc-per-node N -m
deepcharuco_tpu_torch.cli.train --data-parallel [--mesh-spatial S] ...``.
"""

from __future__ import annotations

import argparse
import math
import os
import time


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
                   help="host pipeline threads (default: the config's num_workers)")
    p.add_argument("--data-parallel", action="store_true",
                   help="under torchrun: shard the batch over the ranks (one rank: "
                        "nothing to do)")
    p.add_argument("--mesh-spatial", type=int, default=1,
                   help="with --data-parallel: ranks along the 'spatial' mesh axis "
                        "(image-height sharding of the convolutions)")
    p.add_argument("--device-synth", action="store_true",
                   help="synthesise the training data on the card (else the host pipeline)")
    p.add_argument("--fused-steps", type=int, default=1,
                   help="synthesis + train steps per dispatch")
    p.add_argument("--resume", default=None, help="checkpoint name to resume from")
    p.add_argument("--init-npz", default=None,
                   help="initialize the weights from a shipped .npz (fresh optimizer)")
    p.add_argument("--images", default=None,
                   help="background image directory (host pipeline, bank; else procedural)")
    p.add_argument("--labels", default=None, help="COCO captions json")
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
    p.add_argument("--bg-bank", type=int, default=0,
                   help="with --device-synth: N gray backgrounds built on the host once")
    p.add_argument("--bg-bank-p", type=float, default=0.5,
                   help="probability a sample's background comes from the bank")
    p.add_argument("--mixed-host-every", type=int, default=0,
                   help="with --device-synth: every Nth dispatch trains on a host batch")
    p.add_argument("--eval-host-batches", type=int, default=0,
                   help="with --device-synth: also score N host validation batches per eval")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain versions)")
    return p


def host_batch(dataset, start: int, n: int, device):
    """Samples ``start`` … ``start + n − 1`` of a host dataset, stacked, as
    (images, loc, ids) tensors on ``device``."""
    import numpy as np
    import torch

    items = [dataset[start + k] for k in range(n)]
    return tuple(torch.from_numpy(np.stack([it[key] for it in items])).to(device)
                 for key in ("image", "loc", "ids"))


def host_batches(make_dataset, batch_size: int, workers: int, mesh, device):
    """This rank's batches of a host stream (``BatchLoader``, seed 0, copied
    ahead to ``device``) → (iterator of dicts of tensors, the loader or
    None).

    Under a mesh the rank takes its share of each global batch over
    ``data``. The ranks of a spatial group split the same images by height,
    but a host dataset's draws are not seeded alike on the ranks: the first
    rank of the group builds the share (``make_dataset()`` is called there
    alone) and broadcasts it to the others."""
    from deepcharuco_tpu_torch.data import BatchLoader, device_prefetch
    from deepcharuco_tpu_torch.parallel import broadcast_spatial

    builds = mesh is None or mesh.coords[1] == 0
    share = None if mesh is None else (mesh.coords[0], mesh.shape["data"])
    loader = feed = None
    if builds:
        loader = BatchLoader(make_dataset(), batch_size, num_workers=workers, seed=0,
                             share=share)
        feed = device_prefetch(loader, size=2, device=device)
    if mesh is None or mesh.shape["spatial"] == 1:
        return feed, loader

    def shared():
        while True:
            yield broadcast_spatial(mesh, next(feed) if builds else None)

    return shared(), loader


def start_mesh(args):
    """The mesh of ``--data-parallel`` under ``torchrun`` with more than one
    rank, the process group joined; None otherwise."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if not (args.data_parallel and world > 1):
        return None
    from deepcharuco_tpu_torch.parallel import init_distributed, make_mesh

    n_sp = max(1, args.mesh_spatial)
    if world % n_sp != 0:
        raise SystemExit(
            f"--mesh-spatial {n_sp} does not divide the device count "
            f"{world}; {world % n_sp} device(s) would sit idle — pick a divisor")
    dev = init_distributed(args.device)
    mesh = make_mesh(n_data=world // n_sp, n_spatial=n_sp, device=dev)
    print(f"data-parallel over {world} ranks (mesh {mesh.shape['data']}x"
          f"{mesh.shape['spatial']} data×spatial)", flush=True)
    return mesh


def main(argv=None):
    args = build_argparser().parse_args(argv)
    mesh = start_mesh(args)
    try:
        train(args, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def train(args, mesh=None):
    import torch
    import torch.distributed as dist

    from deepcharuco_tpu_torch._device import resolve_device
    from deepcharuco_tpu_torch.configs import default_config, load_configuration
    from deepcharuco_tpu_torch.data import (CharucoDataset, DeviceSynthesizer,
                                            make_background_bank)
    from deepcharuco_tpu_torch.models import Detector
    from deepcharuco_tpu_torch.parallel import (replicate, sharded_synth_train_program,
                                                sharded_train_step, synth_scan_program)
    from deepcharuco_tpu_torch.train import (create_detector_state, flax_init_,
                                             make_detector_eval_step,
                                             make_detector_train_step, state_variables)
    from deepcharuco_tpu_torch.train.checkpoints import (CheckpointManager,
                                                         optimizer_arrays, resume)
    from deepcharuco_tpu_torch.train.logging import ScalarLogger
    from deepcharuco_tpu_torch.train.metrics import MeanAccumulator, detector_metrics
    from deepcharuco_tpu_torch.weights import (detector_state_dict, load_state,
                                               variables_from_npz)

    dev = resolve_device(args.device) if mesh is None else mesh.device
    lead = mesh is None or dist.get_rank() == mesh.ranks[0]   # evaluates, logs, saves
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
    if mesh is not None:
        replicate(mesh, state)

    step_fn = make_detector_train_step(conf_weight=args.conf_weight,
                                       conf_margin=args.conf_margin, conf_topk=args.conf_topk,
                                       conf_fg_topk=args.conf_fg_topk)
    device_step = step_fn if mesh is None else sharded_train_step(step_fn, mesh)
    workers = args.num_workers or cfg.num_workers
    host = lambda validation=False: CharucoDataset(cfg, labels=args.labels,
                                                   images_folder=args.images,
                                                   validation=validation)
    loader = host_feed = host_val_ds = val_ds = synth = None
    if args.device_synth:
        bank = None
        if args.bg_bank > 0:
            print(f"building {args.bg_bank}-image background bank...", flush=True)
            bank = make_background_bank(args.bg_bank, labels=args.labels,
                                        images_folder=args.images)
        synth = DeviceSynthesizer(
            cfg, axis_snap_p=args.axis_snap_p, bg_bank=bank, bg_bank_p=args.bg_bank_p,
            scale_range=((0.25, args.scale_max) if args.scale_max else None),
            perspective_p=args.perspective_p, low_gain_p=args.low_gain_p,
            low_gain_min=args.low_gain_min, device=dev)
        K = max(1, args.fused_steps)
        if mesh is None:
            program = synth_scan_program(step_fn, lambda g: synth.batch(g, bs), fused_steps=K)
        else:
            program = sharded_synth_train_program(step_fn, synth, mesh, bs, fused_steps=K)
        feed = torch.Generator(device=dev).manual_seed(1234)   # alike on every rank
        if args.eval_host_batches > 0 and lead:
            host_val_ds = host(validation=True)
        if args.mixed_host_every > 0:
            host_feed, loader = host_batches(host, bs, workers, mesh, dev)
            print(f"mixed diet: 1 host batch per {args.mixed_host_every} dispatches")
        print(f"on-card synthesis: batch {bs}, {K} step(s) per dispatch, device {dev}")
    else:
        val_ds = host(validation=True) if lead else None
        host_feed, loader = host_batches(host, bs, workers, mesh, dev)
        print(f"host pipeline: batch {bs}, {workers} threads, device {dev}")
    eval_fn = make_detector_eval_step()

    def host_step(state):
        b = next(host_feed)
        return device_step(state, b["image"], b["loc"], b["ids"])

    def report(i, train_scalars):
        """Rank 0's eval, log line and checkpoint after dispatch ``i``."""
        nonlocal t0
        ev = MeanAccumulator()
        for j in range(args.eval_batches):
            if synth is not None:
                vi, vl, vd = synth.batch(torch.Generator(device=dev).manual_seed(777 + j),
                                         16)
            else:
                vi, vl, vd = host_batch(val_ds, j * 16, 16, dev)
            aux_v, out = eval_fn(state, vi, vl, vd)
            m = detector_metrics(out["loc"], out["ids"], vl, vd, cfg.n_ids)
            ev.update(val_loss=aux_v["loss"], val_loss_loc=aux_v["loss_loc"],
                      val_loss_ids=aux_v["loss_ids"], val_l2_pixels=m["l2_pixels"],
                      val_match_ratio=m["match_ratio"], val_n_pred=m["n_pred"],
                      val_n_target=m["n_target"])
        val_scalars = ev.compute()
        if host_val_ds is not None:
            # the same weights on the host (reference-semantics) stream
            hv = MeanAccumulator()
            for j in range(args.eval_host_batches):
                vi, vl, vd = host_batch(host_val_ds, j * 16, 16, dev)
                aux_v, out = eval_fn(state, vi, vl, vd)
                m = detector_metrics(out["loc"], out["ids"], vl, vd, cfg.n_ids)
                hv.update(val_host_loss=aux_v["loss"], val_host_l2_pixels=m["l2_pixels"],
                          val_host_match_ratio=m["match_ratio"])
            val_scalars.update(hv.compute())
        # the window runs to here: the next one counts this log and save
        sps = args.eval_every / (time.time() - t0)
        t0 = time.time()
        logger.log(i + 1, {**train_scalars, **val_scalars, "steps_per_sec": sps})
        print(f"step {i+1}: train_loss={train_scalars['train_loss']:.4f} "
              f"val_loss={val_scalars['val_loss']:.4f} "
              f"val_l2={val_scalars['val_l2_pixels']:.2f}px "
              f"match={val_scalars['val_match_ratio']:.3f} "
              f"pred/tgt={val_scalars['val_n_pred']:.1f}/{val_scalars['val_n_target']:.1f} "
              + (f"host_match={val_scalars['val_host_match_ratio']:.3f} "
                 if "val_host_match_ratio" in val_scalars else "")
              + f"({sps:.1f} steps/s)", flush=True)
        # named by the global optimizer step, which a resume restores
        ckpts.save(f"step_{state.step:07d}", state_variables(state),
                   metric=val_scalars["val_loss"], optimizer=optimizer_arrays(state))

    logger = ScalarLogger(args.logdir) if lead else None
    acc = MeanAccumulator()
    t0 = time.time()
    try:
        for i in range(args.steps):
            if synth is None or (host_feed is not None and (i + 1) % args.mixed_host_every == 0):
                state, aux = host_step(state)
            else:
                state, aux = program(state, feed)
            acc.update(train_loss=aux["loss"], train_loss_loc=aux["loss_loc"],
                       train_loss_ids=aux["loss_ids"])
            # aux holds the global loss on every rank: all ranks stop together
            if (i + 1) % 100 == 0 and not math.isfinite(float(aux["loss"])):
                print(f"FATAL: non-finite loss at step {i+1}; aborting", flush=True)
                break

            if (i + 1) % args.eval_every == 0:
                train_scalars = acc.compute()
                acc.reset()
                if lead:
                    report(i, train_scalars)
                if mesh is not None:
                    dist.barrier(group=mesh.world)      # the others wait for the eval
    finally:
        if loader is not None:
            loader.stop()
    if lead:
        logger.close()
        print(f"best checkpoint: {ckpts.best_checkpoint()}")


if __name__ == "__main__":
    main()

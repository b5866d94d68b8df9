#!/usr/bin/env python3
"""How far ``chip_smoke.py`` phase 17's two-rank limits sit from a faulty
mesh: the phase's two readings for sound runs and for runs with a fault
planted in the ranks.

Runs the detector trainer (``cli.train`` with phase 17's arguments: the
shipped detector, on-card synthesis, batch 32, lr 1e-4, 4 steps, TF32 off)
in one process, and in two ranks sharing the card under ``torchrun`` on the
2×1 and 1×2 meshes: sound, and with each fault planted:

- ``no-grad-average``: each rank steps on its own gradient (the gradients'
  all-reduce is left out; the logged loss stays the global one);
- ``local-bn``: every BatchNorm takes its batch statistics from this rank's
  samples and rows alone.

The faults are planted in the ranks' processes by replacing a function
before the trainer starts; no file changes. For each two-rank run it prints
the phase's readings against the one-process run: the largest relative
train_loss gap over the logged steps, and rank 0's last checkpoint's
parameters apart in units of lr (``chip_smoke.checkpoint_gap``), then one
JSON line of them all.

Run on a card from the repo root: ``python scripts/probe_torch_parallel_faults.py``.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("sound", "no-grad-average", "local-bn")


def plant(fault: str) -> None:
    """Replace the function that ``fault`` breaks, in this process."""
    import torch
    import torch.distributed as dist

    from deepcharuco_tpu_torch.models.detector import ConvBNRelu
    from deepcharuco_tpu_torch.train import steps

    if fault == "no-grad-average":
        def update(state, loss, aux, mesh=None):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            aux = {k: v.detach() for k, v in aux.items()}
            if mesh is not None:
                scalars = torch.stack(list(aux.values()))
                dist.all_reduce(scalars, group=mesh.data)
                aux = dict(zip(aux, (scalars / mesh.shape["data"]).unbind(0)))
            state.optimizer.step()
            state.step += 1
            return state, aux

        steps._update = update
    elif fault == "local-bn":
        forward = ConvBNRelu.forward
        ConvBNRelu.forward = (lambda self, x, train=False, stats=None, halo=None, then=None:
                              forward(self, x, train, None, halo, then))


def rank_main(fault: str, argv) -> int:
    """One rank under ``torchrun``: the trainer with ``fault`` planted."""
    sys.path.insert(0, ROOT)
    plant(fault)
    from deepcharuco_tpu_torch.cli.train import main

    main(argv)
    return 0


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as CS

    tmp = tempfile.mkdtemp(prefix="probe_parallel_faults_")
    env = CS.parallel_env()
    out = {"card": CS.smi()}
    try:
        cli = ["-m", "deepcharuco_tpu_torch.cli.train"]
        want, want_ck, _, _ = CS.parallel_cli_run(tmp, "one process", [sys.executable] + cli,
                                                  [], env)
        out["one process"] = want
        for fault in FAULTS:
            for layout, extra in (("2x1", ["--data-parallel"]),
                                  ("1x2", ["--data-parallel", "--mesh-spatial", "2"])):
                tag = f"{fault} {layout}"
                launch = CS._torchrun(2) + [os.path.abspath(__file__), "--rank", fault]
                got, ck, _, wall = CS.parallel_cli_run(tmp, tag, launch, extra, env)
                row = {"train_loss": got, "max_rel_loss": CS.loss_gap(got, want),
                       **CS.checkpoint_gap(ck, want_ck, CS.PARALLEL_LR), "wall_s": wall}
                out[tag] = row
                print(f"{tag}: train_loss within {row['max_rel_loss']:.3e} relative "
                      f"(limit {CS.PARALLEL_LOSS_REL}); parameters {row['rms_lr']:.3e} lr "
                      f"apart, root mean square (limit {CS.PARALLEL_PARAM_RMS_LR}), largest "
                      f"{row['max_lr']:.3e} lr; running statistics {row['stats_rel']:.3e}; "
                      f"by step {got}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2], sys.argv[3:]))
    sys.exit(main())

"""Scalar logging: a jsonl file always, TensorBoard where its writer can be
imported (``deepcharuco_tpu.train.logging``, which writes through clu).
The scalar names are the JAX package's (``train_loss``, ``val_loss``,
``val_l2_pixels``, ``val_match_ratio``, ``val_refinenet_loss``, …)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class ScalarLogger:
    def __init__(self, logdir: str, use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")
        self._writer = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:       # no tensorboard package: the jsonl only
                pass
            else:
                self._writer = SummaryWriter(logdir)

    def log(self, step: int, scalars: Dict[str, float]):
        scalars = {k: float(v) for k, v in scalars.items()}
        self._jsonl.write(json.dumps({"step": step, "time": time.time(), **scalars}) + "\n")
        self._jsonl.flush()
        if self._writer is not None:
            for k, v in scalars.items():
                self._writer.add_scalar(k, v, step)
            self._writer.flush()

    def close(self):
        self._jsonl.close()
        if self._writer is not None:
            self._writer.close()

"""Checkpoints with top-k-by-metric retention (``deepcharuco_tpu.train.checkpoints``).

The policy is the JAX package's (the reference's ``ModelCheckpoint(
save_top_k=10, monitor="val_loss")``): every save records its monitored
metric in ``index.json``; past ``top_k`` checkpoints the worst is deleted;
``best_checkpoint``/``latest_checkpoint`` name the best and the newest.

orbax is JAX's, so a checkpoint here is a directory of two numpy files:

- ``variables.npz``: the model in the shipped weight format ('/'-joined
  ``params/...``/``batch_stats/...`` keys, :func:`weights.variables_to_npz`),
  which the JAX package's ``variables_from_npz``, the port's
  ``load_pipeline`` and both trainers' ``--init-npz`` read as it is;
- ``optimizer.npz``: Adam's state per parameter (``exp_avg/<name>``,
  ``exp_avg_sq/<name>``, ``adam_step/<name>``, by the module's parameter
  names) and the global ``step``, so that a resumed run continues the
  moments and the step exactly.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from deepcharuco_tpu_torch import weights as W

VARIABLES = "variables.npz"
OPTIMIZER = "optimizer.npz"


def optimizer_arrays(state) -> Dict[str, np.ndarray]:
    """A :class:`~deepcharuco_tpu_torch.train.steps.TrainState`'s Adam state
    and step as flat numpy arrays, keyed by parameter name."""
    out = {"step": np.asarray(state.step, np.int64)}
    for name, p in state.model.named_parameters():
        st = state.optimizer.state.get(p)
        if not st:
            continue
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"{k}/{name}"] = st[k].detach().cpu().numpy()
        out[f"adam_step/{name}"] = np.asarray(float(st["step"]), np.float32)
    return out


def load_optimizer_arrays(state, arrays: Dict[str, np.ndarray]) -> None:
    """Inverse of :func:`optimizer_arrays`, into ``state`` in place."""
    for name, p in state.model.named_parameters():
        if f"exp_avg/{name}" not in arrays:
            continue
        state.optimizer.state[p] = {
            "step": torch.tensor(float(arrays[f"adam_step/{name}"]), dtype=torch.float32),
            "exp_avg": torch.from_numpy(arrays[f"exp_avg/{name}"]).to(p.device),
            "exp_avg_sq": torch.from_numpy(arrays[f"exp_avg_sq/{name}"]).to(p.device)}
    state.step = int(arrays["step"])


class CheckpointManager:
    """Top-k checkpoint retention keyed by a monitored scalar (lower is better
    unless ``higher_is_better``)."""

    def __init__(self, directory: str, top_k: int = 10, higher_is_better: bool = False):
        self.dir = directory
        self.top_k = top_k
        self.higher_is_better = higher_is_better
        os.makedirs(directory, exist_ok=True)
        self._index_path = os.path.join(directory, "index.json")
        self._index: Dict[str, float] = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def save(self, name: str, variables: Dict, metric: float,
             optimizer: Optional[Dict[str, np.ndarray]] = None) -> str:
        """Write ``variables`` (the JAX-layout tree) and, given, the
        optimizer arrays under ``name`` (e.g. ``step_0001200``); prune to
        the top k."""
        path = self.path(name)
        os.makedirs(path, exist_ok=True)
        W.variables_to_npz(os.path.join(path, VARIABLES), variables)
        if optimizer is not None:
            np.savez(os.path.join(path, OPTIMIZER), **optimizer)
        self._index[name] = float(metric)
        self._prune()
        with open(self._index_path, "w") as f:
            json.dump(self._index, f, indent=1)
        return path

    def _prune(self):
        pick = min if self.higher_is_better else max
        while len(self._index) > self.top_k:
            worst = pick(self._index, key=self._index.get)
            shutil.rmtree(self.path(worst), ignore_errors=True)
            del self._index[worst]

    def restore(self, name: str) -> Dict:
        """``{"variables": tree, "optimizer": arrays or None}`` of ``name``."""
        path = self.path(name)
        opt = os.path.join(path, OPTIMIZER)
        arrays = None
        if os.path.exists(opt):
            with np.load(opt) as z:
                arrays = {k: z[k] for k in z.files}
        return {"variables": W.variables_from_npz(os.path.join(path, VARIABLES)),
                "optimizer": arrays}

    def best_checkpoint(self) -> Optional[str]:
        if not self._index:
            return None
        pick = max if self.higher_is_better else min
        return pick(self._index, key=self._index.get)

    def latest_checkpoint(self) -> Optional[str]:
        return sorted(self._index)[-1] if self._index else None

    @property
    def index(self) -> Dict[str, float]:
        return dict(self._index)


def resume(state, ckpts: CheckpointManager, name: str) -> str:
    """Load checkpoint ``name`` into ``state`` in place: the weights and,
    where the checkpoint has them, Adam's moments and the global step
    (Lightning's ``resume_from_checkpoint``). Returns what was restored,
    for the log."""
    from deepcharuco_tpu_torch.models import Detector

    restored = ckpts.restore(name)
    to_sd = W.detector_state_dict if isinstance(state.model, Detector) else W.refinenet_state_dict
    W.load_state(state.model, to_sd(restored["variables"]))
    if restored["optimizer"] is None:
        return f"resumed from {name} (weights only; Adam's moments start afresh)"
    load_optimizer_arrays(state, restored["optimizer"])
    return f"resumed from {name} at step {state.step} (with optimizer state)"

"""PyTorch-Lightning checkpoints ⇄ the JAX-layout weight tree
(``deepcharuco_tpu.compat.torch_convert``).

The reference ships Lightning ``.ckpt`` files: torch pickles whose
``state_dict`` keys carry a ``model.`` prefix and name each conv and its
BatchNorm apart (``conv1a.weight``, ``bn1a.running_var``). This module maps
them onto the nested ``{"params", "batch_stats"}`` tree of numpy arrays that
the shipped ``.npz`` files hold (``weights.variables_from_npz``), and back;
``weights.detector_state_dict``/``refinenet_state_dict`` take the tree on to
the port's modules. Conv kernels turn between OIHW and HWIO. BatchNorm's
``running_var`` is copied as it is stored. The tables are the reference's
networks: the detector and the 24-px RefineNet without the offset branch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# (layer name in the tree, reference conv name, reference BatchNorm name or None)
DETECTOR_BLOCKS: List[Tuple[str, str, Optional[str]]] = [
    ("conv1a", "conv1a", "bn1a"), ("conv1b", "conv1b", "bn1b"),
    ("conv2a", "conv2a", "bn2a"), ("conv2b", "conv2b", "bn2b"),
    ("conv3a", "conv3a", "bn3a"), ("conv3b", "conv3b", "bn3b"),
    ("conv4a", "conv4a", "bn4a"), ("conv4b", "conv4b", "bn4b"),
    ("convPa", "convPa", "bnPa"), ("convPb", "convPb", None),
    ("convDa", "convDa", "bnDa"), ("convDb", "convDb", None),
]

REFINENET_BLOCKS: List[Tuple[str, str, Optional[str]]] = [
    ("conv1a", "conv1a", "bn1a"), ("conv1b", "conv1b", "bn1b"),
    ("conv2a", "conv2a", "bn2a"), ("conv2b", "conv2b", "bn2b"),
    ("conv3a", "conv3a", "bn3a"), ("conv3b", "conv3b", "bn3b"),
    ("conv4a", "conv4a", "bn4a"), ("conv4b", "conv4b", "bn4b"),
    ("conv5a", "conv5a", "bn5a"), ("conv5b", "conv5b", "bn5b"),
    ("convPa", "convPa", "bnPa"), ("convPb", "convPb", None),
]


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _strip_prefix(state_dict: Dict, prefix: str = "model.") -> Dict[str, np.ndarray]:
    return {(k[len(prefix):] if k.startswith(prefix) else k): _np(v)
            for k, v in state_dict.items()}


def load_lightning_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A Lightning ``.ckpt`` → its state dict as numpy, ``model.`` stripped.
    ``weights_only=False``: Lightning pickles its ``hyper_parameters``,
    which torch's default loader refuses."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return _strip_prefix(ckpt.get("state_dict", ckpt))


def _variables(sd: Dict[str, np.ndarray], blocks) -> Dict:
    params: Dict = {}
    stats: Dict = {}
    for name, conv, bn in blocks:
        layer = {"kernel": sd[f"{conv}.weight"].transpose(2, 3, 1, 0),     # OIHW → HWIO
                 "bias": sd[f"{conv}.bias"]}
        if bn is None:
            params[name] = layer
            continue
        params[name] = {"conv": layer, "bn": {"scale": sd[f"{bn}.weight"],
                                              "bias": sd[f"{bn}.bias"]}}
        stats[name] = {"bn": {"mean": sd[f"{bn}.running_mean"],
                              "var": sd[f"{bn}.running_var"]}}
    return {"params": params, "batch_stats": stats}


def _state_dict(variables: Dict, blocks) -> Dict[str, np.ndarray]:
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    for name, conv, bn in blocks:
        p = params[name] if bn is None else params[name]["conv"]
        sd[f"{conv}.weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1)      # HWIO → OIHW
        sd[f"{conv}.bias"] = _np(p["bias"])
        if bn is not None:
            sd[f"{bn}.weight"] = _np(params[name]["bn"]["scale"])
            sd[f"{bn}.bias"] = _np(params[name]["bn"]["bias"])
            sd[f"{bn}.running_mean"] = _np(stats[name]["bn"]["mean"])
            sd[f"{bn}.running_var"] = _np(stats[name]["bn"]["var"])
    return sd


def detector_variables_from_torch(state_dict: Dict) -> Dict:
    """Reference detector state dict (``model.`` prefix optional) → tree."""
    return _variables(_strip_prefix(state_dict), DETECTOR_BLOCKS)


def refinenet_variables_from_torch(state_dict: Dict) -> Dict:
    """Reference RefineNet state dict (``model.`` prefix optional) → tree."""
    return _variables(_strip_prefix(state_dict), REFINENET_BLOCKS)


def detector_state_dict_from_variables(variables: Dict) -> Dict[str, np.ndarray]:
    """Tree → the reference detector's state dict (numpy, no prefix)."""
    return _state_dict(variables, DETECTOR_BLOCKS)


def refinenet_state_dict_from_variables(variables: Dict) -> Dict[str, np.ndarray]:
    """Tree → the reference RefineNet's state dict (numpy, no prefix); the
    32-px layers and the offset branch, which the reference lacks, are not
    written."""
    return _state_dict(variables, REFINENET_BLOCKS)


def save_lightning_checkpoint(path: str, variables: Dict, kind: str) -> None:
    """Write a weight tree as a Lightning ``.ckpt`` that the reference's
    ``load_from_checkpoint`` reads: a torch pickle whose ``state_dict`` keys
    carry the ``model.`` prefix. ``kind`` is ``"detector"`` or
    ``"refinenet"``."""
    import torch

    if kind not in ("detector", "refinenet"):
        raise ValueError(f"kind must be 'detector' or 'refinenet', got {kind!r}")
    sd = (detector_state_dict_from_variables(variables) if kind == "detector"
          else refinenet_state_dict_from_variables(variables))
    torch.save({"state_dict": {f"model.{k}": torch.from_numpy(np.array(v, order="C"))
                               for k, v in sd.items()},
                "pytorch-lightning_version": "2.1.0", "epoch": 0, "global_step": 0}, path)

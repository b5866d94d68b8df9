"""Weights: the shipped ``.npz`` format ⇄ the port's ``state_dict``s.

The JAX package ships trained weights as compressed ``.npz`` files whose keys
are '/'-joined Flax variable paths (``params/conv1a/conv/kernel``,
``batch_stats/conv1a/bn/mean``, …). This module reads them with numpy alone
and maps each layer onto the port's modules, which carry the same layer
names: a block ``convXY`` with BatchNorm becomes ``convXY.conv`` +
``convXY.bn`` (running statistics included), a bare 1×1 head ``convXb`` a
plain ``Conv2d``. Conv kernels turn from HWIO into OIHW.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# (layer name, has BatchNorm) — the layers of each network, in order.
DETECTOR_BLOCKS: List[Tuple[str, bool]] = [
    ("conv1a", True), ("conv1b", True), ("conv2a", True), ("conv2b", True),
    ("conv3a", True), ("conv3b", True), ("conv4a", True), ("conv4b", True),
    ("convPa", True), ("convPb", False), ("convDa", True), ("convDb", False),
]

REFINENET_BLOCKS: List[Tuple[str, bool]] = [
    ("conv1a", True), ("conv1b", True), ("conv2a", True), ("conv2b", True),
    ("conv3a", True), ("conv3b", True), ("conv4a", True), ("conv4b", True),
    ("conv5a", True), ("conv5b", True), ("convPa", True), ("convPb", False),
]


def read_npz(path: str) -> Dict[str, np.ndarray]:
    """The flat '/'-keyed arrays of a weight file."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def variables_from_npz(path: str) -> Dict:
    """A weight file as the nested ``{"params", "batch_stats"}`` tree of
    numpy arrays that the JAX package's ``variables_from_npz`` returns."""
    tree: Dict = {}
    for key, value in read_npz(path).items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def flatten_variables(variables: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Inverse of the nesting in :func:`variables_from_npz`."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in variables.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_variables(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _state_dict(variables: Dict, blocks) -> Dict[str, np.ndarray]:
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    for name, has_bn in blocks:
        p = params[name]
        conv = p["conv"] if has_bn else p
        prefix = f"{name}.conv" if has_bn else name
        sd[f"{prefix}.weight"] = np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)
        sd[f"{prefix}.bias"] = np.asarray(conv["bias"])
        if has_bn:
            sd[f"{name}.bn.weight"] = np.asarray(p["bn"]["scale"])
            sd[f"{name}.bn.bias"] = np.asarray(p["bn"]["bias"])
            sd[f"{name}.bn.running_mean"] = np.asarray(stats[name]["bn"]["mean"])
            sd[f"{name}.bn.running_var"] = np.asarray(stats[name]["bn"]["var"])
            sd[f"{name}.bn.num_batches_tracked"] = np.zeros((), np.int64)
    return sd


def _variables(state_dict, blocks) -> Dict:
    def a(key):
        v = state_dict[key]
        return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)

    params: Dict = {}
    stats: Dict = {}
    for name, has_bn in blocks:
        prefix = f"{name}.conv" if has_bn else name
        conv = {"kernel": a(f"{prefix}.weight").transpose(2, 3, 1, 0),
                "bias": a(f"{prefix}.bias")}
        if not has_bn:
            params[name] = conv
            continue
        params[name] = {"conv": conv,
                        "bn": {"scale": a(f"{name}.bn.weight"),
                               "bias": a(f"{name}.bn.bias")}}
        stats[name] = {"bn": {"mean": a(f"{name}.bn.running_mean"),
                              "var": a(f"{name}.bn.running_var")}}
    return {"params": params, "batch_stats": stats}


def detector_state_dict(variables: Dict) -> Dict[str, np.ndarray]:
    """JAX-layout detector variables → the port's ``Detector`` state dict."""
    return _state_dict(variables, DETECTOR_BLOCKS)


def refinenet_state_dict(variables: Dict) -> Dict[str, np.ndarray]:
    """JAX-layout RefineNet variables → the port's ``RefineNet`` state dict."""
    return _state_dict(variables, REFINENET_BLOCKS)


def detector_variables(state_dict) -> Dict:
    """Inverse of :func:`detector_state_dict` (tensors or arrays in)."""
    return _variables(state_dict, DETECTOR_BLOCKS)


def refinenet_variables(state_dict) -> Dict:
    """Inverse of :func:`refinenet_state_dict` (tensors or arrays in)."""
    return _variables(state_dict, REFINENET_BLOCKS)


def load_state(module, state_dict: Dict[str, np.ndarray]):
    """Copy a numpy state dict into ``module`` (each parameter keeps its
    own dtype and device) and return the module."""
    import torch

    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in state_dict.items()})
    return module


def load_detector(path: str, n_ids: int = 16, dtype=None, device=None):
    """A :class:`~deepcharuco_tpu_torch.models.Detector` with the weights of
    an ``.npz`` file, in eval mode, on ``device`` (None → the card; without
    a card that raises unless ``device="cpu"``)."""
    import torch

    from deepcharuco_tpu_torch._device import resolve_device
    from deepcharuco_tpu_torch.models import Detector

    dev = resolve_device(device)
    det = Detector(n_ids=n_ids, dtype=dtype or torch.bfloat16)
    return load_state(det, detector_state_dict(variables_from_npz(path))).to(dev).eval()


def load_refinenet(path: str, dtype=None, device=None):
    """A :class:`~deepcharuco_tpu_torch.models.RefineNet` with the weights of
    an ``.npz`` file, in eval mode, on ``device`` (None → the card; without
    a card that raises unless ``device="cpu"``)."""
    import torch

    from deepcharuco_tpu_torch._device import resolve_device
    from deepcharuco_tpu_torch.models import RefineNet

    dev = resolve_device(device)
    rn = RefineNet(dtype=dtype or torch.bfloat16)
    return load_state(rn, refinenet_state_dict(variables_from_npz(path))).to(dev).eval()

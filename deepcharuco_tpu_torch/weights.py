"""Weights: the shipped ``.npz`` format ⇄ the port's ``state_dict``s.

The JAX package ships trained weights as compressed ``.npz`` files whose keys
are '/'-joined Flax variable paths (``params/conv1a/conv/kernel``,
``batch_stats/conv1a/bn/mean``, …). This module reads them with numpy alone
and maps each layer onto the port's modules, which carry the same layer
names: a block ``convXY`` with BatchNorm becomes ``convXY.conv`` +
``convXY.bn`` (running statistics included), a bare 1×1 head ``convXb`` a
plain ``Conv2d``, a ``denseXY`` a ``Linear``. Conv kernels turn from HWIO
into OIHW, dense kernels from (in, out) into (out, in). RefineNet's optional
layers (``conv2c``/``conv2d`` of the 32-px net, the offset branch) are
mapped when the weights hold them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# (layer name, kind) — the layers of each network, in order. Kinds: "bn" a
# conv with BatchNorm, "conv" a bare conv, "dense" a dense layer.
DETECTOR_BLOCKS: List[Tuple[str, str]] = [
    ("conv1a", "bn"), ("conv1b", "bn"), ("conv2a", "bn"), ("conv2b", "bn"),
    ("conv3a", "bn"), ("conv3b", "bn"), ("conv4a", "bn"), ("conv4b", "bn"),
    ("convPa", "bn"), ("convPb", "conv"), ("convDa", "bn"), ("convDb", "conv"),
]

REFINENET_BLOCKS: List[Tuple[str, str]] = [
    ("conv1a", "bn"), ("conv1b", "bn"), ("conv2a", "bn"), ("conv2b", "bn"),
    ("conv2c", "bn"), ("conv2d", "bn"),
    ("conv3a", "bn"), ("conv3b", "bn"), ("conv4a", "bn"), ("conv4b", "bn"),
    ("conv5a", "bn"), ("conv5b", "bn"), ("convPa", "bn"), ("convPb", "conv"),
    ("convOa", "bn"), ("denseOa", "dense"), ("denseOb", "dense"),
]
# RefineNet layers that a set of weights may lack: the 32-px front end's
# extra convs and the offset branch.
REFINENET_OPTIONAL = ("conv2c", "conv2d", "convOa", "denseOa", "denseOb")


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


def variables_to_npz(path: str, variables: Dict) -> None:
    """Write a variable tree in the shipped format: a compressed ``.npz``
    whose keys are the '/'-joined paths (the inverse of
    :func:`variables_from_npz`; the JAX package's ``variables_to_npz``)."""
    np.savez_compressed(path, **flatten_variables(variables))


def _state_dict(variables: Dict, blocks, optional=()) -> Dict[str, np.ndarray]:
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    for name, kind in blocks:
        if name in optional and name not in params:
            continue
        p = params[name]
        if kind == "dense":
            sd[f"{name}.weight"] = np.asarray(p["kernel"]).T
            sd[f"{name}.bias"] = np.asarray(p["bias"])
            continue
        conv = p["conv"] if kind == "bn" else p
        prefix = f"{name}.conv" if kind == "bn" else name
        sd[f"{prefix}.weight"] = np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)
        sd[f"{prefix}.bias"] = np.asarray(conv["bias"])
        if kind == "bn":
            sd[f"{name}.bn.weight"] = np.asarray(p["bn"]["scale"])
            sd[f"{name}.bn.bias"] = np.asarray(p["bn"]["bias"])
            sd[f"{name}.bn.running_mean"] = np.asarray(stats[name]["bn"]["mean"])
            sd[f"{name}.bn.running_var"] = np.asarray(stats[name]["bn"]["var"])
            sd[f"{name}.bn.num_batches_tracked"] = np.zeros((), np.int64)
    return sd


def _variables(state_dict, blocks, optional=()) -> Dict:
    def a(key):
        v = state_dict[key]
        return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)

    params: Dict = {}
    stats: Dict = {}
    for name, kind in blocks:
        prefix = f"{name}.conv" if kind == "bn" else name
        if name in optional and f"{prefix}.weight" not in state_dict:
            continue
        if kind == "dense":
            params[name] = {"kernel": a(f"{name}.weight").T, "bias": a(f"{name}.bias")}
            continue
        conv = {"kernel": a(f"{prefix}.weight").transpose(2, 3, 1, 0),
                "bias": a(f"{prefix}.bias")}
        if kind == "conv":
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
    """JAX-layout RefineNet variables → the port's ``RefineNet`` state dict
    (of the variant whose layers the variables hold)."""
    return _state_dict(variables, REFINENET_BLOCKS, REFINENET_OPTIONAL)


def detector_variables(state_dict) -> Dict:
    """Inverse of :func:`detector_state_dict` (tensors or arrays in)."""
    return _variables(state_dict, DETECTOR_BLOCKS)


def refinenet_variables(state_dict) -> Dict:
    """Inverse of :func:`refinenet_state_dict` (tensors or arrays in)."""
    return _variables(state_dict, REFINENET_BLOCKS, REFINENET_OPTIONAL)


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


def refinenet_variant(variables: Dict) -> Dict:
    """What a set of RefineNet variables fixes of the module's shape:
    ``patch_size`` (32 when ``conv2c`` is there) and ``offset_head``."""
    params = variables["params"]
    return {"patch_size": 32 if "conv2c" in params else 24,
            "offset_head": "denseOa" in params}


def load_refinenet(path: str, dtype=None, device=None, upsample: str = "nearest"):
    """A :class:`~deepcharuco_tpu_torch.models.RefineNet` with the weights of
    an ``.npz`` file (24- or 32-px, with the offset branch if the file has
    one), in eval mode, on ``device`` (None → the card; without a card that
    raises unless ``device="cpu"``)."""
    import torch

    from deepcharuco_tpu_torch._device import resolve_device
    from deepcharuco_tpu_torch.models import RefineNet

    dev = resolve_device(device)
    variables = variables_from_npz(path)
    rn = RefineNet(dtype=dtype or torch.bfloat16, upsample=upsample,
                   **refinenet_variant(variables))
    return load_state(rn, refinenet_state_dict(variables)).to(dev).eval()

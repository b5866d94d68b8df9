"""The port's weight bridge, and the rule that the port imports no JAX."""

import ast
import os

import numpy as np
import pytest
import torch

from deepcharuco_tpu_torch import weights as W
from deepcharuco_tpu_torch.models import Detector, RefineNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = {
    "detector": ("artifacts/detector_devsynth.npz", W.detector_state_dict,
                 W.detector_variables, lambda: Detector(16, torch.float32)),
    "refinenet": ("artifacts/refinenet_devsynth.npz", W.refinenet_state_dict,
                  W.refinenet_variables, lambda: RefineNet(torch.float32)),
}


@pytest.mark.parametrize("kind", sorted(ARTIFACTS))
def test_npz_state_dict_round_trip_is_bit_exact(kind):
    path, to_sd, to_vars, make = ARTIFACTS[kind]
    flat = W.read_npz(os.path.join(ROOT, path))
    module = W.load_state(make(), to_sd(W.variables_from_npz(os.path.join(ROOT, path))))
    back = W.flatten_variables(to_vars(module.state_dict()))
    assert sorted(back) == sorted(flat)
    for key, value in flat.items():
        assert back[key].dtype == value.dtype, key
        np.testing.assert_array_equal(back[key], value, err_msg=key)


@pytest.mark.parametrize("kind", sorted(ARTIFACTS))
def test_loaders_give_eval_modules_with_the_weights(kind):
    path, to_sd, _, _ = ARTIFACTS[kind]
    load = W.load_detector if kind == "detector" else W.load_refinenet
    module = load(os.path.join(ROOT, path), dtype=torch.float32, device="cpu")
    assert not module.training
    sd = to_sd(W.variables_from_npz(os.path.join(ROOT, path)))
    got = module.state_dict()
    assert sorted(got) == sorted(sd)
    np.testing.assert_array_equal(got["conv1a.conv.weight"].numpy(), sd["conv1a.conv.weight"])


@pytest.mark.parametrize("kind", sorted(ARTIFACTS))
def test_loaders_refuse_the_cpu_unless_asked(kind, monkeypatch):
    path = os.path.join(ROOT, ARTIFACTS[kind][0])
    load = W.load_detector if kind == "detector" else W.load_refinenet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load(path)
    with pytest.raises(RuntimeError):
        load(path, device="cuda")


@pytest.mark.parametrize("kind", sorted(ARTIFACTS))
def test_loaders_on_the_cpu_give_the_same_weights(kind):
    path, to_sd, _, _ = ARTIFACTS[kind]
    load = W.load_detector if kind == "detector" else W.load_refinenet
    module = load(os.path.join(ROOT, path), device="cpu")
    sd = to_sd(W.variables_from_npz(os.path.join(ROOT, path)))
    got = module.state_dict()
    assert sorted(got) == sorted(sd)
    for key, value in sd.items():
        assert got[key].device.type == "cpu", key
        want = torch.from_numpy(np.array(value)).to(got[key].dtype)
        assert torch.equal(got[key], want), key


def test_resolve_device_is_shared_by_pipeline_and_weights():
    from deepcharuco_tpu_torch import _device, pipeline
    assert pipeline.resolve_device is _device.resolve_device
    assert _device.resolve_device("cpu") == torch.device("cpu")


def _port_sources():
    pkg = os.path.join(ROOT, "deepcharuco_tpu_torch")
    files = [os.path.join(dp, f) for dp, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    return sorted(os.path.relpath(f, ROOT) for f in files) + ["chip_smoke.py"]


@pytest.mark.parametrize("rel", _port_sources())
def test_port_imports_no_jax(rel):
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read(), filename=rel)
    banned = ("jax", "jaxlib", "flax", "optax", "deepcharuco_tpu")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, f"{rel} imports {name}"

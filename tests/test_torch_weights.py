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
    "refinenet32": ("artifacts/refinenet32_devsynth.npz", W.refinenet_state_dict,
                    W.refinenet_variables,
                    lambda: RefineNet(torch.float32, patch_size=32, offset_head=True)),
}
LOADERS = {"detector": W.load_detector, "refinenet": W.load_refinenet,
           "refinenet32": W.load_refinenet}


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
    load = LOADERS[kind]
    module = load(os.path.join(ROOT, path), dtype=torch.float32, device="cpu")
    assert not module.training
    sd = to_sd(W.variables_from_npz(os.path.join(ROOT, path)))
    got = module.state_dict()
    assert sorted(got) == sorted(sd)
    np.testing.assert_array_equal(got["conv1a.conv.weight"].numpy(), sd["conv1a.conv.weight"])


@pytest.mark.parametrize("kind", sorted(ARTIFACTS))
def test_loaders_refuse_the_cpu_unless_asked(kind, monkeypatch):
    path = os.path.join(ROOT, ARTIFACTS[kind][0])
    load = LOADERS[kind]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load(path)
    with pytest.raises(RuntimeError):
        load(path, device="cuda")


@pytest.mark.parametrize("kind", sorted(ARTIFACTS))
def test_loaders_on_the_cpu_give_the_same_weights(kind):
    path, to_sd, _, _ = ARTIFACTS[kind]
    load = LOADERS[kind]
    module = load(os.path.join(ROOT, path), device="cpu")
    sd = to_sd(W.variables_from_npz(os.path.join(ROOT, path)))
    got = module.state_dict()
    assert sorted(got) == sorted(sd)
    for key, value in sd.items():
        assert got[key].device.type == "cpu", key
        want = torch.from_numpy(np.array(value)).to(got[key].dtype)
        assert torch.equal(got[key], want), key


def test_refinenet32_artifact_has_90_keys_and_every_layer_is_mapped():
    flat = W.read_npz(os.path.join(ROOT, ARTIFACTS["refinenet32"][0]))
    assert len(flat) == 90
    sd = W.refinenet_state_dict(W.variables_from_npz(
        os.path.join(ROOT, ARTIFACTS["refinenet32"][0])))
    for layer in ("conv2c", "conv2d", "convOa"):
        assert f"{layer}.conv.weight" in sd and f"{layer}.bn.running_var" in sd
    assert sd["denseOa.weight"].shape == (256, 2048) and sd["denseOb.weight"].shape == (2, 256)
    assert sd["conv2c.conv.weight"].shape == (128, 128, 3, 3)


@pytest.mark.parametrize("patch_size", [24, 32])
@pytest.mark.parametrize("offset_head", [False, True])
def test_seeded_flax_init_round_trips_through_the_state_dict(patch_size, offset_head):
    """Variables from a seeded Flax ``init`` of each variant → state dict →
    module → variables: the same keys and bits; the dense kernels come back
    in Flax's (in, out) layout."""
    import jax
    import jax.numpy as jnp

    from deepcharuco_tpu.models import RefineNet as JRefineNet
    v = JRefineNet(dtype=jnp.float32, patch_size=patch_size, offset_head=offset_head).init(
        jax.random.PRNGKey(11), jnp.zeros((1, patch_size, patch_size, 1), jnp.float32))
    v = {"params": jax.tree.map(np.asarray, v["params"]),
         "batch_stats": jax.tree.map(np.asarray, v["batch_stats"])}
    assert W.refinenet_variant(v) == {"patch_size": patch_size, "offset_head": offset_head}
    flat = W.flatten_variables(v)
    module = W.load_state(RefineNet(torch.float32, patch_size=patch_size,
                                    offset_head=offset_head), W.refinenet_state_dict(v))
    back = W.flatten_variables(W.refinenet_variables(module.state_dict()))
    assert sorted(back) == sorted(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    if offset_head:
        assert back["params/denseOa/kernel"].shape == (2048, 256)


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


@pytest.mark.parametrize("rel", _port_sources())
def test_port_imports_no_cv2_at_module_level(rel):
    """The GPU machine has no cv2: no module of the port may need it to be
    imported."""
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read(), filename=rel)
    for node in tree.body:
        if isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] != "cv2" for a in node.names), rel
        elif isinstance(node, ast.ImportFrom):
            assert (node.module or "").split(".")[0] != "cv2", rel


def test_the_static_checks_cover_the_new_modules():
    rels = _port_sources()
    for want in ("board.py", "pnp/__init__.py", "pnp/projection.py", "pnp/smallmath.py",
                 "pnp/solve.py", "pnp/ransac.py", "pipeline.py", "ops/geom.py",
                 "models/quant.py", "serving.py", "profiling.py", "data/__init__.py",
                 "data/device_synth.py", "train/__init__.py", "train/steps.py",
                 "train/metrics.py", "train/checkpoints.py", "train/logging.py",
                 "parallel/__init__.py", "cli/__init__.py", "cli/train.py",
                 "cli/train_refinenet.py", "compat/__init__.py", "compat/torch_convert.py",
                 "utils.py", "pose_filter.py", "bench.py", "cli/benchmark.py",
                 "cli/infer.py", "cli/eval.py", "cli/pose_video.py"):
        assert os.path.join("deepcharuco_tpu_torch", *want.split("/")) in rels

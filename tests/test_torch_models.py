"""The port's Detector and RefineNet against the Flax modules, in float32 on
the CPU, with the shipped and with random-init weights. The tolerance covers
the two frameworks' different summation orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcharuco_tpu.models import Detector as JDetector
from deepcharuco_tpu.models import RefineNet as JRefineNet
from deepcharuco_tpu.pipeline import variables_from_npz
from deepcharuco_tpu_torch import weights as W
from deepcharuco_tpu_torch.models import Detector, RefineNet

TOL = dict(atol=1e-4, rtol=1e-4)


def _variables(kind, source, shape):
    if source == "shipped":
        return variables_from_npz(f"artifacts/{kind}_devsynth.npz")
    model = JDetector(n_ids=16, dtype=jnp.float32) if kind == "detector" else \
        JRefineNet(dtype=jnp.float32)
    v = model.init(jax.random.PRNGKey(3), jnp.zeros(shape, jnp.float32))
    # non-trivial BN statistics, so the running stats are exercised
    rng = np.random.default_rng(5)
    stats = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape)
                         .astype(np.float32), v["batch_stats"])
    return {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": stats}


@pytest.mark.parametrize("source", ["shipped", "random"])
@pytest.mark.parametrize("shape", [(2, 64, 96, 1), (2, 60, 84, 1)])
def test_detector_matches_flax(source, shape):
    v = _variables("detector", source, shape)
    x = np.random.default_rng(0).uniform(-0.5, 0.5, shape).astype(np.float32)
    jdet = JDetector(n_ids=16, dtype=jnp.float32)
    ref = jdet.apply(v, jnp.asarray(x))
    ref_trunk = jdet.apply(v, jnp.asarray(x), trunk_only=True)["trunk"]
    det = W.load_state(Detector(16, torch.float32), W.detector_state_dict(v)).eval()
    with torch.inference_mode():
        out = det(torch.from_numpy(x))
        trunk = det(torch.from_numpy(x), trunk_only=True)["trunk"]
    for key in ("loc", "ids"):
        assert out[key].shape == ref[key].shape
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL)
    np.testing.assert_allclose(trunk.numpy(), np.asarray(ref_trunk), **TOL)


@pytest.mark.parametrize("source", ["shipped", "random"])
def test_refinenet_matches_flax(source):
    shape = (5, 24, 24, 1)
    v = _variables("refinenet", source, shape)
    x = np.random.default_rng(1).uniform(-0.5, 0.5, shape).astype(np.float32)
    ref = JRefineNet(dtype=jnp.float32).apply(v, jnp.asarray(x))
    rn = W.load_state(RefineNet(torch.float32), W.refinenet_state_dict(v)).eval()
    with torch.inference_mode():
        heat = rn(torch.from_numpy(x))
    assert heat.shape == (5, 64, 64, 1)
    np.testing.assert_allclose(heat.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kwargs", [dict(patch_size=32), dict(upsample="bilinear"),
                                    dict(offset_head=True)])
def test_refinenet_variants_not_ported_yet(kwargs):
    with pytest.raises(NotImplementedError):
        RefineNet(**kwargs)


def test_bf16_detector_keeps_float32_batchnorm_and_logits():
    det = Detector(16)
    assert det.conv1a.conv.weight.dtype == torch.bfloat16
    assert det.conv1a.bn.running_var.dtype == torch.float32
    with torch.inference_mode():
        out = det(torch.zeros(1, 16, 16, 1))
        trunk = det(torch.zeros(1, 16, 16, 1), trunk_only=True)["trunk"]
    assert out["loc"].dtype == torch.float32 and out["loc"].shape == (1, 2, 2, 65)
    assert trunk.dtype == torch.bfloat16 and trunk.is_contiguous()

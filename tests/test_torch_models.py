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


def _variables(kind, source, shape, **rn_kwargs):
    if source == "shipped":
        return variables_from_npz(f"artifacts/{kind}_devsynth.npz")
    model = JDetector(n_ids=16, dtype=jnp.float32) if kind == "detector" else \
        JRefineNet(dtype=jnp.float32, **rn_kwargs)
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


@pytest.mark.parametrize("patch_size", [24, 32])
@pytest.mark.parametrize("upsample", ["nearest", "bilinear"])
@pytest.mark.parametrize("offset_head", [False, True])
def test_refinenet_variants_match_flax(patch_size, upsample, offset_head):
    """Every variant in float32 with random-init weights: heatmap within
    1e-4, offset within 1e-4 px."""
    shape = (4, patch_size, patch_size, 1)
    kw = dict(patch_size=patch_size, upsample=upsample, offset_head=offset_head)
    v = _variables("refinenet", "random", shape, **kw)
    x = np.random.default_rng(2).uniform(-0.5, 0.5, shape).astype(np.float32)
    ref = JRefineNet(dtype=jnp.float32, **kw).apply(v, jnp.asarray(x))
    rn = W.load_state(RefineNet(torch.float32, **kw), W.refinenet_state_dict(v)).eval()
    with torch.inference_mode():
        out = rn(torch.from_numpy(x))
    if offset_head:
        assert sorted(out) == ["heat", "offset"] and out["offset"].shape == (4, 2)
        np.testing.assert_allclose(out["offset"].numpy(), np.asarray(ref["offset"]),
                                   atol=1e-4, rtol=0)
        out, ref = out["heat"], ref["heat"]
    assert out.shape == (4, 64, 64, 1) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("upsample", ["nearest", "bilinear"])
def test_refinenet32_shipped_weights_match_flax(upsample):
    """The shipped 32-px weights, which hold a trained offset branch."""
    v = variables_from_npz("artifacts/refinenet32_devsynth.npz")
    assert W.refinenet_variant(v) == {"patch_size": 32, "offset_head": True}
    x = np.random.default_rng(4).uniform(-0.5, 0.5, (3, 32, 32, 1)).astype(np.float32)
    kw = dict(patch_size=32, upsample=upsample, offset_head=True)
    ref = JRefineNet(dtype=jnp.float32, **kw).apply(v, jnp.asarray(x))
    rn = W.load_state(RefineNet(torch.float32, **kw), W.refinenet_state_dict(v)).eval()
    with torch.inference_mode():
        out = rn(torch.from_numpy(x))
    np.testing.assert_allclose(out["heat"].numpy(), np.asarray(ref["heat"]), **TOL)
    np.testing.assert_allclose(out["offset"].numpy(), np.asarray(ref["offset"]),
                               atol=1e-4, rtol=0)


def test_offset_branch_flattens_rows_cols_channels():
    """denseOa's 2048 inputs are the (4, 4, 128) map flattened row, column,
    channel (the JAX module flattens NHWC); a channel-first flatten of the
    same map gives another offset."""
    import torch.nn.functional as F

    from deepcharuco_tpu_torch.models.detector import pool, to_nchw
    torch.manual_seed(0)
    rn = RefineNet(torch.float32, offset_head=True).eval()
    x = torch.rand(2, 24, 24, 1) - 0.5
    with torch.inference_mode():
        t = rn.conv2b(rn.conv2a(rn.conv1b(rn.conv1a(to_nchw(x)))))
        o = pool(rn.convOa(rn.conv3b(rn.conv3a(pool(t)))))          # (2, 128, 4, 4)
        head = lambda flat: rn.denseOb(F.relu(rn.denseOa(flat)))
        nhwc = head(o.permute(0, 2, 3, 1).reshape(2, -1))
        nchw = head(o.reshape(2, -1))
        got = rn(x)["offset"]
    np.testing.assert_allclose(got.numpy(), nhwc.numpy(), atol=1e-6)
    assert (got - nchw).abs().max() > 1e-3


def test_bilinear_upsample_matches_jax_resize_in_bf16():
    """``jax.image.resize(..., "bilinear")`` at ×2 is half-pixel centers with
    clamped edges, ``align_corners=False`` here. In bf16, on the
    non-negative maps the net upsamples (they follow a ReLU, so a blend
    cancels nothing), the two agree to two bf16 steps (2⁻⁷ relative)."""
    from deepcharuco_tpu.models.refinenet import _upsample_bilinear_2x
    x = np.abs(np.random.default_rng(6).normal(size=(2, 8, 8, 5))).astype(np.float32)
    rn = RefineNet(torch.float32, upsample="bilinear")
    ref32 = np.asarray(_upsample_bilinear_2x(jnp.asarray(x)))
    got32 = rn._up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got32.numpy(), ref32, atol=1e-6)
    ref16 = np.asarray(_upsample_bilinear_2x(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got16 = rn._up(torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), ref16, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("kwargs", [dict(patch_size=16), dict(patch_size=48),
                                    dict(patch_size=0)])
def test_refinenet_variants_not_ported_yet(kwargs):
    """No variant is left unported; a patch size that the JAX module refuses
    (anything but 24 and 32) is refused here with the same error."""
    with pytest.raises(ValueError, match="patch_size must be 24 or 32"):
        RefineNet(**kwargs)
    x = jnp.zeros((1, 24, 24, 1), jnp.float32)
    with pytest.raises(ValueError, match="patch_size must be 24 or 32"):
        JRefineNet(**kwargs).init(jax.random.PRNGKey(0), x)


def test_bf16_detector_keeps_float32_batchnorm_and_logits():
    det = Detector(16)
    assert det.conv1a.conv.weight.dtype == torch.bfloat16
    assert det.conv1a.bn.running_var.dtype == torch.float32
    with torch.inference_mode():
        out = det(torch.zeros(1, 16, 16, 1))
        trunk = det(torch.zeros(1, 16, 16, 1), trunk_only=True)["trunk"]
    assert out["loc"].dtype == torch.float32 and out["loc"].shape == (1, 2, 2, 65)
    assert trunk.dtype == torch.bfloat16 and trunk.is_contiguous()

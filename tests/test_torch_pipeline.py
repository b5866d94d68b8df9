"""The port's slice end to end — frames → corners → sub-pixel corners —
against the JAX package on the fixture frames, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcharuco_tpu.models import Detector as JDetector
from deepcharuco_tpu.models import RefineNet as JRefineNet
from deepcharuco_tpu.ops import normalize_gray as jnormalize_gray
from deepcharuco_tpu.ops.pallas_fused import fold_head_params as jfold
from deepcharuco_tpu.ops.pallas_fused import pallas_fused_head_decode
from deepcharuco_tpu.pipeline import two_stage_forward as jtwo_stage_forward
from deepcharuco_tpu.pipeline import variables_from_npz as jvariables_from_npz
from deepcharuco_tpu_torch.configs import default_config
from deepcharuco_tpu_torch.models import Detector
from deepcharuco_tpu_torch.pipeline import (InferencePipeline, _to_gray_input,
                                            load_pipeline, two_stage_forward)
from deepcharuco_tpu_torch.weights import variables_from_npz

FIXTURE = "tests/data/torch_port_frames.npz"
DET = "artifacts/detector_devsynth.npz"
RN = "artifacts/refinenet_devsynth.npz"
CFG = default_config()


@pytest.fixture(scope="module")
def fix():
    return dict(np.load(FIXTURE))


@pytest.fixture(scope="module")
def jax_f32(fix):
    """The JAX package's f32 slice on the first two fixture frames."""
    det, rn = JDetector(n_ids=16, dtype=jnp.float32), JRefineNet(dtype=jnp.float32)
    dv, rv = jvariables_from_npz(DET), jvariables_from_npz(RN)
    out = jax.jit(lambda dv, rv, x: jtwo_stage_forward(det, rn, dv, rv, x, 16))(
        dv, rv, jnp.asarray(fix["frames"][:2]))
    return tuple(np.asarray(o) for o in out)


@pytest.fixture(scope="module")
def jax_fused(fix):
    """The JAX fused composition (bf16 trunk → Pallas kernel) on two frames."""
    dv = jvariables_from_npz(DET)
    trunk = JDetector(n_ids=16).apply(dv, jnormalize_gray(jnp.asarray(fix["frames"][:2])),
                                      trunk_only=True)["trunk"]
    kp, valid = pallas_fused_head_decode(trunk, jfold(dv, 16), 16, interpret=True)
    return np.asarray(kp), np.asarray(valid)


def _pipe(**kw):
    return InferencePipeline(CFG, variables_from_npz(DET), variables_from_npz(RN),
                             device="cpu", **kw)


def test_fixture_outputs_still_match_the_jax_package(fix, jax_f32, jax_fused):
    kp, valid, refined = jax_f32
    np.testing.assert_array_equal(valid, fix["valid_f32"][:2])
    np.testing.assert_array_equal(kp[valid], fix["keypoints_f32"][:2][valid])
    np.testing.assert_allclose(refined[valid], fix["refined_f32"][:2][valid], atol=1e-3)
    fk, fv = jax_fused
    np.testing.assert_array_equal(fv, fix["valid_fused"][:2])
    np.testing.assert_array_equal(fk[fv], fix["keypoints_fused"][:2][fv])
    assert fix["frames"].shape == (8, 240, 320) and fix["frames"].dtype == np.uint8
    assert fix["valid_f32"].sum() >= 100


def test_slice_f32_matches_jax(fix, jax_f32):
    kr, vr, rr = jax_f32
    kp, valid, refined = _pipe(compute_dtype=torch.float32).detect(fix["frames"][:2])
    np.testing.assert_array_equal(valid, vr)
    np.testing.assert_array_equal(kp[vr], kr[vr])
    np.testing.assert_allclose(refined[vr], rr[vr], atol=1e-3)


def _mismatch(kp, v, kr, vr):
    both = v & vr
    return (v != vr).mean(), ((np.abs(kp - kr).max(-1) > 0) & both).mean()


def test_fused_head_matches_jax_fused_composition(fix, jax_fused):
    kr, vr = jax_fused
    kp, valid, refined = _pipe(fused_head=True).detect(fix["frames"][:2])
    slot, coord = _mismatch(kp, valid, kr, vr)
    assert slot <= 0.02 and coord <= 0.02, (slot, coord)
    assert (kp[~valid] == 0).all()  # the fused decode writes (0, 0) there


@pytest.mark.parametrize("fused_head", [False, True])
def test_slice_bf16_agrees_with_jax_bf16(fix, fused_head):
    kp, valid, refined = _pipe(fused_head=fused_head).detect(fix["frames"])
    kr, vr, rr = (fix[f"{k}_bf16"] for k in ("keypoints", "valid", "refined"))
    slot, coord = _mismatch(kp, valid, kr, vr)
    assert slot <= 0.02 and coord <= 0.02, (slot, coord)
    agree = valid & vr & (np.abs(kp - kr).max(-1) == 0)
    assert (np.abs(refined - rr).max(-1)[agree] <= 0.125).mean() >= 0.98


def test_inference_pipeline_numpy_io_and_keypoint_array(fix):
    pipe = load_pipeline(CFG, DET, RN, device="cpu")
    kp, valid, refined = pipe.detect(fix["frames"][:2])
    assert isinstance(kp, np.ndarray) and kp.shape == (2, 16, 2) and kp.dtype == np.float32
    assert valid.shape == (2, 16) and valid.dtype == bool
    assert refined.shape == (2, 16, 2) and np.isfinite(refined).all()
    rows = pipe.keypoint_array(refined[0], valid[0])
    assert rows.shape == (valid[0].sum(), 3)
    np.testing.assert_array_equal(rows[:, 2], np.nonzero(valid[0])[0])
    np.testing.assert_array_equal(rows[:, :2], refined[0][valid[0]])
    # BGR frames go through the same gray conversion
    bgr = np.repeat(fix["frames"][:1, ..., None], 3, axis=-1)
    _, v_bgr, _ = pipe.detect(bgr)
    assert v_bgr.shape == (1, 16)


def test_float_frames_are_taken_as_normalized(fix):
    u8 = torch.from_numpy(fix["frames"][:1])
    g = _to_gray_input(u8)
    np.testing.assert_array_equal(_to_gray_input(g[..., 0]).numpy(), g.numpy())
    np.testing.assert_array_equal(_to_gray_input(g).numpy(), g.numpy())


def test_detector_only_pipeline_returns_raw_keypoints(fix):
    pipe = InferencePipeline(CFG, variables_from_npz(DET), device="cpu")
    kp, valid, refined = pipe.detect(fix["frames"][:1])
    np.testing.assert_array_equal(kp, refined)


@pytest.mark.parametrize("entry", ["InferencePipeline", "load_pipeline",
                                   "two_stage_forward"])
def test_entry_points_raise_without_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = np.zeros((1, 240, 320), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "InferencePipeline":
            InferencePipeline(CFG, variables_from_npz(DET))
        elif entry == "load_pipeline":
            load_pipeline(CFG, DET)
        else:
            two_stage_forward(Detector(16, torch.float32).eval(), None, frames, 16)


@pytest.mark.parametrize("kwargs", [dict(decode_capacity=2), dict(geom_decode=True),
                                    dict(hires=True), dict(rn_decode="soft"),
                                    dict(soft_refine=True), dict(camera=object()),
                                    dict(det_quant="int8")])
def test_options_outside_the_slice_are_not_ported(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferencePipeline(CFG, variables_from_npz(DET), device="cpu", **kwargs)

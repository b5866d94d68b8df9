"""The port's slice end to end — frames → corners → sub-pixel corners →
pose — against the JAX package on the fixture frames, on the CPU.

Tolerances in float32: keypoints and ``valid`` exact on valid slots,
``refined`` exact for the hard decode and ≤ 1e-3 px for the soft, offset and
avg decodes, ``ok`` equal, |Δrvec| ≤ 1e-3 rad, |Δtvec| ≤ 1e-3·|tvec|,
|Δrms| ≤ 1e-3 px. In bf16 the limits are the ones ``PERF.md`` §2 states."""

import types

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
from deepcharuco_tpu.board import inner_corner_object_points as jobject_points
from deepcharuco_tpu.pipeline import Camera as JCamera
from deepcharuco_tpu.pipeline import InferencePipeline as JInferencePipeline
from deepcharuco_tpu.pipeline import full_forward as jfull_forward
from deepcharuco_tpu.pipeline import full_forward_hires as jfull_forward_hires
from deepcharuco_tpu.pipeline import two_stage_forward as jtwo_stage_forward
from deepcharuco_tpu.pipeline import variables_from_npz as jvariables_from_npz
from deepcharuco_tpu_torch.configs import default_config
from deepcharuco_tpu_torch.models import Detector, RefineNet
from deepcharuco_tpu_torch.pipeline import (Camera, InferencePipeline, _apply_refiner,
                                            _to_gray_input, full_forward,
                                            full_forward_hires, load_pipeline,
                                            two_stage_forward, two_stage_forward_hires)
from deepcharuco_tpu_torch.weights import (load_detector, load_refinenet,
                                           variables_from_npz)

FIXTURE = "tests/data/torch_port_frames.npz"
DET = "artifacts/detector_devsynth.npz"
RN = "artifacts/refinenet_devsynth.npz"
RN32 = "artifacts/refinenet32_devsynth.npz"
CFG = default_config()
OBJ = jobject_points(5, 5, 0.01)
K0 = np.array([[420.0, 0.0, 160.0], [0.0, 420.0, 120.0], [0.0, 0.0, 1.0]])


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


@pytest.mark.parametrize("kwargs", [dict(geom_fill=True), dict(geom_decode=True),
                                    dict(geom_decode=True, geom_fill=True),
                                    dict(geom_decode=True, decode_capacity=2),
                                    dict(geom_decode=True, hires=True),
                                    dict(det_quant="int8", camera=object()),
                                    dict(det_quant="int8")])
def test_options_outside_the_slice_are_not_ported(kwargs):
    """These options were open until the geometry decode and the int8
    detector were ported: none raises ``NotImplementedError`` any more. Each
    combination now builds, or raises the JAX package's own guard."""
    guards = {("geom_fill",): "geom_fill requires geom_decode=True",
              ("decode_capacity", "geom_decode"): "exclusive",
              ("geom_decode", "hires"): "hires tap needs RefineNet weights"}
    guard = guards.get(tuple(sorted(kwargs)))
    det_vars = variables_from_npz(DET)
    if "det_quant" in kwargs:
        from deepcharuco_tpu_torch.models.quant import qvars_from_npz
        det_vars = qvars_from_npz("artifacts/detector_devsynth_int8.npz")
        kwargs = {**kwargs, "camera": None}
    if guard:
        with pytest.raises(ValueError, match=guard):
            InferencePipeline(CFG, det_vars, device="cpu", **kwargs)
        return
    pipe = InferencePipeline(CFG, det_vars, device="cpu", **kwargs)
    kp, valid, refined = pipe.detect(np.zeros((1, 64, 64), np.uint8))
    assert kp.shape == (1, 16, 2) and not valid.any()


def test_functional_entry_points_refuse_the_geometry_decode(fix, tmp_path):
    """They no longer refuse it: with ``geom_board_xy`` both run, and on a
    frame without a board (an untrained detector finds no six consistent
    corners) they give the parity decode. What is still refused is a
    checkpoint format that is JAX's own: an orbax directory."""
    det = Detector(16, torch.float32).eval()
    xy = OBJ[:, :2]
    x = fix["frames"][:1]
    want = two_stage_forward(det, None, x, 16, device="cpu")
    for fn, extra in ((two_stage_forward, ()), (full_forward, (OBJ, fix["K"], fix["dist"]))):
        got = fn(det, None, x, 16, *extra, geom_board_xy=xy, device="cpu")
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0][want[1]], want[0][want[1]])
    (tmp_path / "checkpoint").write_text("{}")
    with pytest.raises(ValueError, match="JAX's format"):
        load_pipeline(CFG, str(tmp_path), device="cpu")


# ------------------------------------------------------------------ camera

@pytest.mark.parametrize("n", [0, 4, 5, 8, 12])
def test_camera_from_npz_pads_to_12(tmp_path, rng, n):
    path = str(tmp_path / "camera_params.npz")
    coeffs = rng.normal(size=(1, n)).astype(np.float64)
    np.savez(path, camera_matrix=K0, distortion_coeffs=coeffs)
    cam, ref = Camera.from_npz(path), JCamera.from_npz(path)
    np.testing.assert_array_equal(cam.K, ref.K)
    np.testing.assert_array_equal(cam.dist, ref.dist)
    assert cam.dist.shape == (12,) and cam.dist.dtype == np.float32
    assert (cam.dist[n:] == 0).all()


@pytest.mark.parametrize("n", [14, 3])
def test_camera_from_npz_refuses_other_models(tmp_path, n):
    path = str(tmp_path / "camera_params.npz")
    np.savez(path, camera_matrix=K0, distortion_coeffs=np.zeros(n))
    for cls in (Camera, JCamera):
        with pytest.raises(ValueError, match=f"{n}-coefficient distortion model"):
            cls.from_npz(path)


@pytest.mark.parametrize("factor", [0.5, 0.25, 2.0])
def test_camera_scaled_matches_jax(fix, factor):
    cam = Camera(K=fix["K_hi"], dist=fix["dist"]).scaled(factor)
    ref = JCamera(K=fix["K_hi"], dist=fix["dist"]).scaled(factor)
    np.testing.assert_array_equal(cam.K, ref.K)
    np.testing.assert_array_equal(cam.dist, ref.dist)
    assert Camera(K=fix["K_hi"], dist=fix["dist"]).scaled().K[0, 2] == 159.75


# -------------------------------------------------------------- pose, f32

def _assert_pose_close(got, ref, rad=1e-3, rel=1e-3, px=1e-3):
    ok, rvec, tvec, rms = got
    ok_r, rvec_r, tvec_r, rms_r = ref
    np.testing.assert_array_equal(ok, ok_r)
    assert ok_r.any()
    assert np.abs(rvec - rvec_r).max() <= rad
    assert (np.linalg.norm(tvec - tvec_r, axis=-1)
            <= rel * np.linalg.norm(tvec_r, axis=-1) + 1e-12).all()
    np.testing.assert_allclose(rms[ok_r], rms_r[ok_r], atol=px)


def _assert_corners_equal(got, ref, refined_atol=0.0):
    kp, valid, refined = got
    kr, vr, rr = ref
    np.testing.assert_array_equal(valid, vr)
    np.testing.assert_array_equal(kp[vr], kr[vr])
    np.testing.assert_allclose(refined[vr], rr[vr], atol=refined_atol, rtol=0)


def _models(rn_path=RN, **rn_kwargs):
    det = load_detector(DET, dtype=torch.float32, device="cpu")
    rn = load_refinenet(rn_path, dtype=torch.float32, device="cpu", **rn_kwargs)
    return det, rn


def test_full_forward_f32_matches_jax(fix):
    """Live JAX ``full_forward`` on two frames, the port's on the same two,
    and the stored float32 outputs of all eight."""
    jdet, jrn = JDetector(n_ids=16, dtype=jnp.float32), JRefineNet(dtype=jnp.float32)
    dv, rv = jvariables_from_npz(DET), jvariables_from_npz(RN)
    ref = jax.jit(lambda dv, rv, x: jfull_forward(
        jdet, jrn, dv, rv, x, 16, jnp.asarray(OBJ), jnp.asarray(fix["K"]),
        jnp.asarray(fix["dist"])))(dv, rv, jnp.asarray(fix["frames"][:2]))
    ref = tuple(np.asarray(o) for o in ref)
    det, rn = _models()
    got = tuple(t.numpy() for t in full_forward(det, rn, fix["frames"], 16, OBJ, fix["K"],
                                                fix["dist"], device="cpu"))
    assert [g.shape for g in got] == [(8, 16, 2), (8, 16), (8, 16, 2), (8,), (8, 3),
                                      (8, 3), (8,)]
    _assert_corners_equal(tuple(g[:2] for g in got[:3]), ref[:3])
    _assert_pose_close(tuple(g[:2] for g in got[3:]), ref[3:])
    stored = tuple(fix[f"{k}_f32"] for k in ("keypoints", "valid", "refined", "ok", "rvec",
                                             "tvec", "rms"))
    _assert_corners_equal(got[:3], stored[:3])
    _assert_pose_close(got[3:], stored[3:])


@pytest.mark.parametrize("scale", [2, 4])
def test_full_forward_hires_f32_matches_jax(fix, scale):
    """The hi-res tap with the 32-px RefineNet and the soft decode, live
    against JAX on two frames (at scale 4 the 480×640 frames enlarged 2× by
    repetition, so the detector sees the same 240×320 view)."""
    x = fix["frames_hi"][:2]
    if scale == 4:
        x = x.repeat(2, axis=1).repeat(2, axis=2)
    cam = Camera(K=fix["K_hi"] * np.array([[scale / 2], [scale / 2], [1]], np.float32),
                 dist=fix["dist"]).scaled(1.0 / scale)
    jdet = JDetector(n_ids=16, dtype=jnp.float32)
    jrn = JRefineNet(dtype=jnp.float32, patch_size=32)
    dv, rv = jvariables_from_npz(DET), jvariables_from_npz(RN32)
    ref = jax.jit(lambda dv, rv, x: jfull_forward_hires(
        jdet, jrn, dv, rv, x, 16, jnp.asarray(OBJ), jnp.asarray(cam.K),
        jnp.asarray(cam.dist), rn_decode="soft", scale=scale))(dv, rv, jnp.asarray(x))
    ref = tuple(np.asarray(o) for o in ref)
    det, rn = _models(RN32)
    assert rn.patch_size == 32
    got = tuple(t.numpy() for t in full_forward_hires(
        det, rn, x, 16, OBJ, cam.K, cam.dist, rn_decode="soft", scale=scale, device="cpu"))
    assert ref[1].sum() >= 20
    _assert_corners_equal(got[:3], ref[:3], refined_atol=1e-3)
    _assert_pose_close(got[3:], ref[3:])
    assert got[2][got[1]].max() < 320          # LOW-res units
    if scale == 2:
        stored = tuple(fix[f"{k}_hires_f32"][:2] for k in
                       ("keypoints", "valid", "refined", "ok", "rvec", "tvec", "rms"))
        _assert_corners_equal(got[:3], stored[:3], refined_atol=1e-3)
        _assert_pose_close(got[3:], stored[3:])


def _offset_variables(fix):
    """The shipped 24-px weights plus the fixture's seeded offset branch."""
    rv = variables_from_npz(RN)
    for key in fix:
        if key.startswith("rn_offset/"):
            _, coll, layer, *rest = key.split("/")
            node = rv[coll].setdefault(layer, {})
            for p in rest[:-1]:
                node = node.setdefault(p, {})
            node[rest[-1]] = fix[key].astype(np.float32)
    return rv


@pytest.mark.parametrize("mode", ["soft", "offset", "avg"])
def test_refinement_decodes_f32_match_jax(fix, mode):
    """``rn_decode`` through the pipeline: soft against live JAX on two
    frames, offset and avg (the fixture's seeded branch on the shipped
    weights) against the stored JAX outputs of all eight."""
    rv = _offset_variables(fix)
    pipe = InferencePipeline(CFG, variables_from_npz(DET), rv, rn_decode=mode,
                             compute_dtype=torch.float32, device="cpu")
    assert pipe.refinenet.offset_head == (mode != "soft")
    if mode == "soft":
        jdet, jrn = JDetector(n_ids=16, dtype=jnp.float32), JRefineNet(dtype=jnp.float32)
        ref = jax.jit(lambda dv, rv, x: jtwo_stage_forward(
            jdet, jrn, dv, rv, x, 16, soft_refine=True))(
            jvariables_from_npz(DET), jvariables_from_npz(RN), jnp.asarray(fix["frames"][:2]))
        ref = tuple(np.asarray(o) for o in ref)
        got = pipe.detect(fix["frames"][:2])
    else:
        ref = (fix["keypoints_f32"], fix["valid_f32"], fix[f"refined_{mode}_f32"])
        got = pipe.detect(fix["frames"])
    _assert_corners_equal(got, ref, refined_atol=1e-3)
    hard = ref[0][ref[1]]
    assert np.abs(got[2][ref[1]] - hard).max() > 1e-3       # not the hard decode


@pytest.mark.parametrize("fused_head", [False, True])
@pytest.mark.parametrize("mode", ["offset", "avg"])
def test_refinement_decodes_bf16_agree_with_jax_bf16(fix, mode, fused_head):
    pipe = InferencePipeline(CFG, variables_from_npz(DET), _offset_variables(fix),
                             rn_decode=mode, fused_head=fused_head, device="cpu")
    kp, valid, refined = pipe.detect(fix["frames"])
    kr, vr, rr = fix["keypoints_bf16"], fix["valid_bf16"], fix[f"refined_{mode}_bf16"]
    agree = valid & vr & (np.abs(kp - kr).max(-1) == 0)
    assert agree.sum() >= 100
    assert (np.abs(refined - rr).max(-1)[agree] <= 0.125).mean() >= 0.98


def test_decode_capacity_f32_matches_jax(fix):
    jdet, jrn = JDetector(n_ids=16, dtype=jnp.float32), JRefineNet(dtype=jnp.float32)
    ref = jax.jit(lambda dv, rv, x: jtwo_stage_forward(
        jdet, jrn, dv, rv, x, 16, decode_capacity=4))(
        jvariables_from_npz(DET), jvariables_from_npz(RN), jnp.asarray(fix["frames"][:2]))
    ref = tuple(np.asarray(o) for o in ref)
    pipe = _pipe(compute_dtype=torch.float32, decode_capacity=4)
    got = pipe.detect(fix["frames"][:2])
    assert got[0].shape == (2, 16, 4, 2) and got[1].shape == (2, 16, 4)
    assert got[2].shape == (2, 16, 4, 2)
    _assert_corners_equal(got, ref)
    # slot 0 is the one-slot decode; the pose path always runs that
    one = _pipe(compute_dtype=torch.float32).detect(fix["frames"][:2])
    np.testing.assert_array_equal(got[1][:, :, 0], one[1])
    np.testing.assert_array_equal(got[2][:, :, 0][one[1]], one[2][one[1]])
    # K-slot rows: duplicate slots become duplicate rows with the same id
    rows = pipe.keypoint_array(got[2][0], got[1][0])
    ref_rows = JInferencePipeline.keypoint_array(None, ref[2][0], ref[1][0])
    np.testing.assert_array_equal(rows, ref_rows)
    assert rows.shape == (got[1][0].sum(), 3) and (np.diff(rows[:, 2]) >= 0).all()


def test_decode_capacity_bf16_agrees_with_jax_bf16(fix):
    kp, valid, refined = _pipe(decode_capacity=4).detect(fix["frames"])
    kr, vr, rr = (fix[f"{k}_top4"] for k in ("keypoints", "valid", "refined"))
    slot, coord = _mismatch(kp, valid, kr, vr)
    assert slot <= 0.02 and coord <= 0.02, (slot, coord)
    agree = valid & vr & (np.abs(kp - kr).max(-1) == 0)
    assert (np.abs(refined - rr).max(-1)[agree] <= 0.125).mean() >= 0.98


@pytest.mark.parametrize("fused_head", [False, True])
def test_pose_bf16_agrees_with_jax_bf16(fix, fused_head):
    """The bf16 pose path on the CPU against the stored JAX bf16 outputs: on
    frames where ``ok`` agrees and every valid slot is within 0.125 px,
    |Δrvec| ≤ 0.02 rad and |Δtvec| ≤ 0.02·|tvec|; ``ok`` differs on at most
    one frame."""
    cam = Camera(K=fix["K"], dist=fix["dist"])
    out = _pipe(camera=cam, fused_head=fused_head).detect_with_pose(fix["frames"])
    assert len(out) == 7
    _, valid, refined, ok, rvec, tvec, rms = out
    ok_r, vr, rr = fix["ok_bf16"], fix["valid_bf16"], fix["refined_bf16"]
    assert (ok != ok_r).sum() <= 1
    near = np.where(valid & vr, np.abs(refined - rr).max(-1), 0.0).max(-1) <= 0.125
    frames = ok & ok_r & near & (valid == vr).all(-1)
    assert frames.sum() >= 4
    assert np.abs(rvec - fix["rvec_bf16"])[frames].max() <= 0.02
    dt = np.linalg.norm(tvec - fix["tvec_bf16"], axis=-1)
    assert (dt <= 0.02 * np.linalg.norm(fix["tvec_bf16"], axis=-1))[frames].all()


def test_detector_only_pose_f32_matches_jax(fix):
    """No RefineNet: the pose is solved from the raw keypoints."""
    jdet = JDetector(n_ids=16, dtype=jnp.float32)
    ref = jax.jit(lambda dv, x: jfull_forward(
        jdet, None, dv, None, x, 16, jnp.asarray(OBJ), jnp.asarray(fix["K"]),
        jnp.asarray(fix["dist"])))(jvariables_from_npz(DET), jnp.asarray(fix["frames"][:2]))
    ref = tuple(np.asarray(o) for o in ref)
    pipe = InferencePipeline(CFG, variables_from_npz(DET), compute_dtype=torch.float32,
                             camera=Camera(K=fix["K"], dist=fix["dist"]), device="cpu")
    got = pipe.detect_with_pose(fix["frames"][:2])
    _assert_corners_equal(got[:3], ref[:3])
    np.testing.assert_array_equal(got[0], got[2])
    _assert_pose_close(got[3:], ref[3:])


# ----------------------------------------------------- the accurate set-up

def test_hires_pipeline_with_pose_in_low_res_units(fix, monkeypatch):
    """The configuration the README recommends: 32-px RefineNet, hi-res tap
    at scale 2, a camera calibrated at the input resolution."""
    cam = Camera(K=fix["K_hi"], dist=fix["dist"])
    pipe = load_pipeline(CFG, DET, RN32, camera=cam, rn_patch_size=32, hires=2,
                         compute_dtype=torch.float32, device="cpu")
    assert pipe.hires and pipe.hires_scale == 2 and pipe.rn_decode == "soft"
    out = pipe.detect_with_pose(fix["frames_hi"][:2])
    assert len(out) == 7 and all(isinstance(o, np.ndarray) for o in out)
    stored = tuple(fix[f"{k}_hires_f32"][:2] for k in
                   ("keypoints", "valid", "refined", "ok", "rvec", "tvec", "rms"))
    _assert_corners_equal(out[:3], stored[:3], refined_atol=1e-3)
    _assert_pose_close(out[3:], stored[3:])
    assert out[2][out[1]].max() < 320
    kp, valid, refined = pipe.detect(fix["frames_hi"][:2])
    np.testing.assert_array_equal(refined, out[2])
    xy = pipe.input_coords(refined)
    ref = JInferencePipeline.input_coords(types.SimpleNamespace(hires=True, hires_scale=2),
                                          refined)
    np.testing.assert_array_equal(xy, ref)
    np.testing.assert_array_equal(xy, 2 * refined + 0.5)
    base = _pipe()
    np.testing.assert_array_equal(base.input_coords(refined), refined)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_pipeline(CFG, DET, RN32, camera=cam, rn_patch_size=32, hires=2)


@pytest.mark.parametrize("hires,fused_head", [(True, True), (4, False)])
def test_hires_options(fix, hires, fused_head):
    """``hires=True`` is scale 2; the fused decode serves the tap too; the
    bf16 tap at scale 2 agrees with the stored JAX bf16 outputs."""
    pipe = load_pipeline(CFG, DET, RN32, rn_patch_size=32, hires=hires,
                         fused_head=fused_head, device="cpu")
    scale = 2 if hires is True else hires
    assert pipe.hires_scale == scale
    x = fix["frames_hi"][:2]
    if scale == 4:
        x = x.repeat(2, axis=1).repeat(2, axis=2)
    kp, valid, refined = pipe.detect(x)
    kr, vr = fix["keypoints_hires_bf16"][:2], fix["valid_hires_bf16"][:2]
    slot, coord = _mismatch(kp, valid, kr, vr)
    assert slot <= 0.07 and coord <= 0.07, (slot, coord)   # 32 slots: two may differ
    assert valid.sum() >= 20 and np.isfinite(refined).all()
    assert np.abs(refined - kp)[valid].max() <= 4.5 / 2    # within the heatmap window


# ------------------------------------------------------------------ guards

@pytest.mark.parametrize("kwargs,match", [
    (dict(hires=3), "hires accepts True/2/4"),
    (dict(hires=2, rn=None), "hires tap needs RefineNet weights"),
    (dict(hires=2, decode_capacity=2), "hires does not support decode_capacity"),
    (dict(fused_head=True, decode_capacity=2), "decode_capacity > 1 needs fused_head=False"),
    (dict(rn_decode="avg"), "needs RefineNet\\(offset_head=True\\)"),
    (dict(rn_decode="offset"), "needs RefineNet\\(offset_head=True\\)"),
    (dict(rn_patch_size=32), "rn_patch_size=32 does not fit"),
    (dict(rn_patch_size=24, rn=RN32), "rn_patch_size=24 does not fit"),
])
def test_guards_raise_value_error(kwargs, match):
    kwargs = dict(kwargs)
    rn = kwargs.pop("rn", RN)
    with pytest.raises(ValueError, match=match):
        InferencePipeline(CFG, variables_from_npz(DET),
                          variables_from_npz(rn) if rn else None, device="cpu", **kwargs)


def test_functional_guards_raise_value_error(fix):
    det, rn = _models()
    x = fix["frames"][:1]
    with pytest.raises(ValueError, match="scale 2 or 4"):
        two_stage_forward_hires(det, rn, x, 16, scale=3, device="cpu")
    with pytest.raises(ValueError, match="decode_capacity > 1 needs fused_head=False"):
        two_stage_forward(det, rn, x, 16, decode_capacity=2, fused_head=True, device="cpu")
    patches = torch.zeros(1, 16, 24, 24)
    for mode in ("offset", "avg"):
        with pytest.raises(ValueError, match="offset_head=True"):
            _apply_refiner(rn, patches, torch.zeros(1, 16, 2), mode)
    with pytest.raises(ValueError, match="built without a Camera"):
        _pipe().detect_with_pose(x)
    with pytest.raises(ValueError, match="tilted-sensor"):
        full_forward(det, rn, x, 16, OBJ, fix["K"], np.zeros(14, np.float32), device="cpu")


def test_trained_offset_branch_of_the_32px_weights_serves_avg(fix):
    """The shipped 32-px weights hold a trained offset branch: ``avg`` on the
    hi-res tap lands within a quarter pixel of the soft decode."""
    soft = load_pipeline(CFG, DET, RN32, rn_patch_size=32, hires=2,
                         compute_dtype=torch.float32, device="cpu").detect(fix["frames_hi"][:1])
    avg = load_pipeline(CFG, DET, RN32, rn_patch_size=32, hires=2, rn_decode="avg",
                        compute_dtype=torch.float32, device="cpu").detect(fix["frames_hi"][:1])
    np.testing.assert_array_equal(avg[1], soft[1])
    d = np.abs(avg[2] - soft[2])[soft[1]]
    assert 0 < d.max() <= 0.25

"""The ``geom_*`` options of the port's pipeline against the JAX package, on
the CPU, in float32 end to end (the functions themselves are held to JAX's
in ``tests/test_torch_geom.py``).

The same frames go through both; the RANSAC seed's Gumbel tables are the
ones JAX draws from ``PRNGKey(0)``, stored in the fixture and passed into
the port. Tolerances: ``valid`` and ``filled`` masks exact, keypoints within
1e-4 px, ``refined`` within 1e-3 px, pose as in
``tests/test_torch_pipeline.py`` (1e-3 rad, 1e-3·|tvec|, 1e-3 px of rms)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcharuco_tpu.models import Detector as JDetector
from deepcharuco_tpu.models import RefineNet as JRefineNet
from deepcharuco_tpu.pipeline import full_forward as jfull_forward
from deepcharuco_tpu.pipeline import two_stage_forward as jtwo_stage_forward
from deepcharuco_tpu.pipeline import variables_from_npz as jvariables_from_npz
from deepcharuco_tpu_torch.board import inner_corner_object_points
from deepcharuco_tpu_torch.configs import default_config
from deepcharuco_tpu_torch.pipeline import (Camera, InferencePipeline, _trust_fills,
                                            full_forward, full_forward_hires,
                                            load_pipeline, two_stage_forward,
                                            two_stage_forward_hires)
from deepcharuco_tpu_torch.weights import load_detector, load_refinenet

FIXTURE = "tests/data/torch_port_frames.npz"
DET = "artifacts/detector_devsynth.npz"
RN = "artifacts/refinenet_devsynth.npz"
RN32 = "artifacts/refinenet32_devsynth.npz"
CFG = default_config()
OBJ = inner_corner_object_points(5, 5, 0.01)
GEOM_KEYS = ("keypoints", "valid", "refined", "ok", "rvec", "tvec", "rms", "filled")


def jax_noise(n_subsets, n_ids, capacity):
    """The Gumbel tables ``ops.geom._ransac_seed`` draws, as it draws them."""
    def draw(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.gumbel(k1, (n_ids,)), jax.random.gumbel(k2, (n_ids, capacity)))

    g, gs = jax.vmap(draw)(jax.random.split(jax.random.PRNGKey(0), n_subsets))
    return np.array(g), np.array(gs)


@pytest.fixture(scope="module")
def fix():
    return dict(np.load(FIXTURE))


def _stored(fix, tag, rows=slice(None)):
    return tuple(fix[f"{k}_{tag}"][rows] for k in GEOM_KEYS)


def _assert_geom_close(got, ref):
    kp, valid, refined, ok, rvec, tvec, rms, filled = got
    kr, vr, rr, ok_r, rvec_r, tvec_r, rms_r, filled_r = ref
    np.testing.assert_array_equal(valid, vr)
    np.testing.assert_array_equal(filled, filled_r)
    np.testing.assert_allclose(kp[vr], kr[vr], atol=1e-4)
    np.testing.assert_allclose(refined[vr], rr[vr], atol=1e-3)
    np.testing.assert_array_equal(ok, ok_r)
    assert ok_r.any()
    assert np.abs(rvec - rvec_r).max() <= 1e-3
    assert (np.linalg.norm(tvec - tvec_r, axis=-1)
            <= 1e-3 * np.linalg.norm(tvec_r, axis=-1) + 1e-12).all()
    np.testing.assert_allclose(rms[ok_r], rms_r[ok_r], atol=1e-3)


def _fixture_noise(fix):
    return fix["geom_noise_g"], fix["geom_noise_gs"]


def _port_geom(fix, fill, hires, rows=slice(None)):
    det = load_detector(DET, dtype=torch.float32, device="cpu")
    kw = dict(geom_board_xy=OBJ[:, :2], geom_fill=fill, geom_noise=_fixture_noise(fix),
              device="cpu")
    if hires:
        rn = load_refinenet(RN32, dtype=torch.float32, device="cpu")
        cam = Camera(K=fix["K_hi"], dist=fix["dist"]).scaled(0.5)
        x = fix["frames_hi"][rows]
        out = full_forward_hires(det, rn, x, 16, OBJ, cam.K, cam.dist, rn_decode="soft",
                                 scale=2, **kw)
        filled = two_stage_forward_hires(det, rn, x, 16, rn_decode="soft", scale=2,
                                         return_filled=True, **kw)[3]
    else:
        rn = load_refinenet(RN, dtype=torch.float32, device="cpu")
        x = fix["frames"][rows]
        out = full_forward(det, rn, x, 16, OBJ, fix["K"], fix["dist"], **kw)
        filled = two_stage_forward(det, rn, x, 16, return_filled=True, **kw)[3]
    return tuple(t.numpy() for t in (*out, filled))


def test_fixture_noise_is_what_jax_draws(fix):
    g, gs = jax_noise(32, 16, 5)
    np.testing.assert_array_equal(fix["geom_noise_g"], g)
    np.testing.assert_array_equal(fix["geom_noise_gs"], gs)


def test_full_forward_geom_fill_f32_matches_live_jax(fix):
    """Live JAX ``full_forward`` with ``geom_fill`` on the last two frames
    (the last one has a hole that the fill closes) against the port's, and
    against the stored outputs of those frames."""
    jdet, jrn = JDetector(n_ids=16, dtype=jnp.float32), JRefineNet(dtype=jnp.float32)
    dv, rv = jvariables_from_npz(DET), jvariables_from_npz(RN)
    kw = dict(geom_board_xy=jnp.asarray(OBJ[:, :2]), geom_fill=True)
    ref = jax.jit(lambda dv, rv, x: (
        *jfull_forward(jdet, jrn, dv, rv, x, 16, jnp.asarray(OBJ), jnp.asarray(fix["K"]),
                       jnp.asarray(fix["dist"]), **kw),
        jtwo_stage_forward(jdet, jrn, dv, rv, x, 16, return_filled=True, **kw)[3]))(
        dv, rv, jnp.asarray(fix["frames"][6:]))
    ref = tuple(np.asarray(o) for o in ref)
    got = _port_geom(fix, fill=True, hires=False, rows=slice(6, None))
    _assert_geom_close(got, ref)
    _assert_geom_close(ref, _stored(fix, "geomfill_f32", slice(6, None)))
    assert ref[7][1].sum() >= 1             # the last frame has a hole to fill


@pytest.mark.parametrize("fill", [False, True])
@pytest.mark.parametrize("hires", [False, True])
def test_geom_options_f32_match_stored_jax(fix, fill, hires):
    tag = ("hires_" if hires else "") + ("geomfill" if fill else "geom") + "_f32"
    got = _port_geom(fix, fill, hires)
    ref = _stored(fix, tag)
    _assert_geom_close(got, ref)
    if hires:
        assert got[2][got[1]].max() < 320       # LOW-res units
    if fill:
        assert ref[7].any() and not (ref[7] & ~ref[1]).any()
    else:
        assert not got[7].any()


def test_pose_ignores_filled_corners(fix):
    """With ``geom_fill`` the pose comes from the measured detections only:
    the same rvec/tvec as the geometry decode alone, bit for bit, while the
    corner set holds the fills."""
    cam = Camera(K=fix["K"], dist=fix["dist"])
    kw = dict(camera=cam, geom_decode=True, geom_noise=_fixture_noise(fix),
              compute_dtype=torch.float32, device="cpu")
    geom = load_pipeline(CFG, DET, RN, **kw)
    fill = load_pipeline(CFG, DET, RN, geom_fill=True, **kw)
    out_g, out_f = geom.detect_with_pose(fix["frames"]), fill.detect_with_pose(fix["frames"])
    assert out_f[1].sum() > out_g[1].sum()                  # fills only add
    assert (out_f[1] | ~out_g[1]).all()
    for a, b in zip(out_g[3:], out_f[3:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out_f[1], fix["valid_geomfill_f32"])
    # solving from the filled set too gives another pose
    from deepcharuco_tpu_torch.pnp import solve_pnp_batch
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    _, rvec_all, _, _ = solve_pnp_batch(as_t(OBJ), as_t(out_f[2]), torch.from_numpy(out_f[1]),
                                        as_t(fix["K"]), as_t(fix["dist"]))
    assert np.abs(rvec_all.numpy() - out_f[4]).max() > 0


def test_trust_guard_replaces_drifted_fills_only():
    kp = torch.tensor([[[10.0, 10.0], [20.0, 20.0], [30.0, 30.0], [40.0, 40.0]]])
    refined = kp + torch.tensor([[[1.0, 1.0], [1.2, 1.2], [3.0, 0.0], [0.0, 1.5]]])
    filled = torch.tensor([[True, True, False, True]])
    out = _trust_fills(refined, kp, filled)
    # |(1, 1)| = 1.41 stays, |(1.2, 1.2)| = 1.70 goes back to the prediction,
    # a detected corner is never touched, a drift of exactly 1.5 stays
    np.testing.assert_array_equal(out.numpy(), [[[11.0, 11.0], [20.0, 20.0], [33.0, 30.0],
                                                 [40.0, 41.5]]])


def test_pipeline_guards_are_the_jax_packages(fix):
    dv = jvariables_from_npz(DET)
    with pytest.raises(ValueError, match="exclusive"):
        InferencePipeline(CFG, dv, None, geom_decode=True, decode_capacity=4, device="cpu")
    with pytest.raises(ValueError, match="geom_fill requires"):
        InferencePipeline(CFG, dv, None, geom_fill=True, device="cpu")
    with pytest.raises(ValueError, match="fused_head=False"):
        InferencePipeline(CFG, dv, None, geom_decode=True, fused_head=True, device="cpu")
    det = load_detector(DET, dtype=torch.float32, device="cpu")
    x = fix["frames"][:1]
    with pytest.raises(ValueError, match="geom_fill requires geom_board_xy"):
        two_stage_forward(det, None, x, 16, geom_fill=True, device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        two_stage_forward(det, None, x, 16, geom_board_xy=OBJ[:, :2], decode_capacity=2,
                          device="cpu")
    with pytest.raises(ValueError, match="fused_head=False"):
        two_stage_forward(det, None, x, 16, geom_board_xy=OBJ[:, :2], fused_head=True,
                          device="cpu")
    # a detector-only pipeline: the fills come back as they were predicted
    pipe = InferencePipeline(CFG, dv, None, geom_decode=True, geom_fill=True,
                             compute_dtype=torch.float32, device="cpu")
    kp, valid, refined = pipe.detect(fix["frames"][:2])
    assert kp.shape == (2, 16, 2) and valid.shape == (2, 16)
    np.testing.assert_array_equal(kp, refined)

"""The port's batched planar PnP against the JAX package's, on the same
numpy inputs from a seed, in float32 on the CPU.

Tolerances: the camera model and the small linear algebra agree to 1e-5
(relative to the size of the values: pixels are hundreds, so 1e-5·|value| +
1e-5); poses after the 20 LM iterations to 1e-3 rad and 1e-3·|tvec|, which
is the tolerance the JAX package's own tests state against cv2, and ``ok``
is equal. JAX runs jitted and vmapped as its tests run it; the port runs the
same batch as one batch-first call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcharuco_tpu.board import inner_corner_object_points as jobject_points
from deepcharuco_tpu.pnp import projection as JP
from deepcharuco_tpu.pnp import ransac as JR
from deepcharuco_tpu.pnp import smallmath as JM
from deepcharuco_tpu.pnp import solve as JS
from deepcharuco_tpu_torch import board as TB
from deepcharuco_tpu_torch.pnp import projection as TP
from deepcharuco_tpu_torch.pnp import ransac as TR
from deepcharuco_tpu_torch.pnp import smallmath as TM
from deepcharuco_tpu_torch.pnp import solve as TS

K = np.array([[420.0, 0.0, 160.0], [0.0, 420.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
K_DEG = np.array([[400.0, 0, 160.0], [0, 400.0, 120.0], [0, 0, 1.0]], np.float32)
DISTS = {
    0: np.zeros(0, np.float32),
    5: np.array([0.05, -0.02, 0.001, -0.0015, 0.01], np.float32),
    8: np.array([0.12, -0.2, 0.001, -0.002, 0.05, 0.3, -0.1, 0.02], np.float32),
    12: np.array([0.1, -0.15, 0.001, -0.002, 0.03, 0.25, -0.08, 0.01,
                  0.0005, -0.0003, 0.0004, -0.0002], np.float32),
}
OBJ = jobject_points(5, 5, 0.01)
CLOSE = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pad12(d):
    return np.concatenate([d, np.zeros(12 - len(d), np.float32)])


def _poses(rng, n, max_angle=1.2):
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    rvec = (axis * rng.uniform(0.1, max_angle, (n, 1))).astype(np.float32)
    tvec = np.stack([rng.uniform(-0.03, 0.03, n), rng.uniform(-0.03, 0.03, n),
                     rng.uniform(0.15, 0.5, n)], axis=1).astype(np.float32)
    return rvec, tvec


def _project(rvec, tvec, k=K, dist=DISTS[5]):
    fn = jax.vmap(lambda r, t: JP.project_points(jnp.asarray(OBJ), r, t, jnp.asarray(k),
                                                 jnp.asarray(dist)))
    return np.array(fn(jnp.asarray(rvec), jnp.asarray(tvec)))


# ---------------------------------------------------------------- board

@pytest.mark.parametrize("rows,cols", [(5, 5), (4, 6), (7, 5)])
def test_board_geometry_exact(rows, cols):
    from deepcharuco_tpu import board as JB
    np.testing.assert_array_equal(TB.inner_corner_object_points(rows, cols, 0.013),
                                  JB.inner_corner_object_points(rows, cols, 0.013))
    np.testing.assert_array_equal(TB.inner_corner_pixels((321, 240), rows, cols),
                                  JB.inner_corner_pixels((321, 240), rows, cols))
    assert TB.n_inner_corners(rows, cols) == JB.n_inner_corners(rows, cols)


# ----------------------------------------------------------- projection

@pytest.mark.parametrize("kind", ["random", "small", "near_pi"])
def test_rodrigues_and_inverse(rng, kind):
    rvec, _ = _poses(rng, 12, max_angle=3.0)
    if kind == "small":
        rvec = (rvec * 1e-9).astype(np.float32)
        rvec[0] = 0.0
    elif kind == "near_pi":
        rvec = (rvec / np.linalg.norm(rvec, axis=1, keepdims=True)
                * (np.pi - 1e-5)).astype(np.float32)
    R_ref = np.asarray(jax.vmap(JP.rodrigues)(jnp.asarray(rvec)))
    R = TP.rodrigues(_t(rvec))
    np.testing.assert_allclose(R.numpy(), R_ref, **CLOSE)
    np.testing.assert_allclose(TP.rodrigues(_t(rvec[3])).numpy(), R_ref[3], **CLOSE)
    back_ref = np.asarray(jax.vmap(JP.rodrigues_inverse)(jnp.asarray(R_ref)))
    back = TP.rodrigues_inverse(_t(R_ref)).numpy()
    assert np.isfinite(back).all()
    # near π the axis comes from square roots of 1 + R_ii, which amplify a
    # last-bit difference in the input's use; 1e-3 rad there
    np.testing.assert_allclose(back, back_ref, atol=1e-3 if kind == "near_pi" else 1e-5)


@pytest.mark.parametrize("n", sorted(DISTS))
def test_distort_and_undistort(rng, n):
    xn = rng.uniform(-0.5, 0.5, (3, 30, 2)).astype(np.float32)
    ref = np.asarray(JP.distort(jnp.asarray(xn), jnp.asarray(DISTS[n])))
    np.testing.assert_allclose(TP.distort(_t(xn), _t(DISTS[n])).numpy(), ref, **CLOSE)
    pts = rng.uniform([20, 20], [300, 220], size=(3, 30, 2)).astype(np.float32)
    ref = np.asarray(JP.undistort_normalize(jnp.asarray(pts), jnp.asarray(K),
                                            jnp.asarray(DISTS[n])))
    got = TP.undistort_normalize(_t(pts), _t(K), _t(DISTS[n])).numpy()
    np.testing.assert_allclose(got, ref, **CLOSE)


def test_dist12_pads_and_refuses_the_tilted_model():
    for n, d in DISTS.items():
        got = TP._dist12(d).numpy()
        np.testing.assert_array_equal(got, np.asarray(JP._dist12(jnp.asarray(d))))
        assert got.shape == (12,) and got.dtype == np.float32
    with pytest.raises(ValueError, match="14-coefficient"):
        TP._dist12(np.zeros(14, np.float32))


@pytest.mark.parametrize("n", sorted(DISTS))
def test_project_points(rng, n):
    rvec, tvec = _poses(rng, 6)
    ref = _project(rvec, tvec, dist=DISTS[n])
    got = TP.project_points(_t(OBJ), _t(rvec), _t(tvec), _t(K), _t(DISTS[n])).numpy()
    assert got.shape == (6, 16, 2)
    np.testing.assert_allclose(got, ref, **CLOSE)
    one = TP.project_points(_t(OBJ), _t(rvec[0]), _t(tvec[0]), _t(K), _t(DISTS[n]))
    np.testing.assert_allclose(one.numpy(), ref[0], **CLOSE)


@pytest.mark.parametrize("n", sorted(DISTS))
@pytest.mark.parametrize("angle", ["generic", "tiny"])
def test_analytic_jacobian_matches_jax_jacfwd(rng, n, angle):
    """The LM's 2N×6 Jacobian: analytic here, forward-mode in JAX. Entries
    are up to 1e4 px per unit; 1e-4 relative to the largest entry."""
    rvec, tvec = _poses(rng, 5)
    if angle == "tiny":
        rvec = (rvec * 1e-7).astype(np.float32)
    dist = jnp.asarray(DISTS[n])
    f = lambda p: JP.project_points(jnp.asarray(OBJ), p[:3], p[3:], jnp.asarray(K), dist)
    p = jnp.asarray(np.concatenate([rvec, tvec], axis=1))
    ref = np.asarray(jax.vmap(jax.jacfwd(f))(p))                   # (5, 16, 2, 6)
    pix, J = TP.project_points_jacobian(_t(OBJ), _t(rvec), _t(tvec), _t(K), _t(DISTS[n]))
    assert J.shape == (5, 16, 2, 6)
    np.testing.assert_allclose(J.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_array_equal(
        pix.numpy(),
        TP.project_points(_t(OBJ), _t(rvec), _t(tvec), _t(K), _t(DISTS[n])).numpy())


# ------------------------------------------------------------ smallmath

def _spd(rng, batch, n):
    a = rng.normal(size=(batch, n, n)).astype(np.float32)
    return a @ a.transpose(0, 2, 1) + 0.5 * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("n", [3, 6, 9])
@pytest.mark.parametrize("jitter", [0.0, 1e-3])
def test_cholesky_solve(rng, n, jitter):
    A, b = _spd(rng, 7, n), rng.normal(size=(7, n)).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda a, v: JM.cholesky_solve(a, v, n, jitter=jitter))(
        jnp.asarray(A), jnp.asarray(b)))
    got = TM.cholesky_solve(_t(A), _t(b), jitter).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(TM.cholesky_solve(_t(A[0]), _t(b[0]), jitter).numpy(),
                               ref[0], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["zero", "rank1", "indefinite"])
def test_cholesky_solve_clamps_pivots_instead_of_raising(kind):
    """A matrix that is not positive definite gives what the JAX package's
    clamped pivots give (finite here), where torch.linalg.cholesky raises."""
    n = 4
    v = np.arange(1, n + 1, dtype=np.float32)
    A = {"zero": np.zeros((n, n), np.float32), "rank1": np.outer(v, v),
         "indefinite": np.diag([1.0, -1.0, 2.0, 0.0]).astype(np.float32)}[kind]
    b = np.ones(n, np.float32)
    ref = np.asarray(JM.cholesky_solve(jnp.asarray(A), jnp.asarray(b), n))
    got = TM.cholesky_solve(_t(A), _t(b)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-3)
    with pytest.raises(Exception):
        torch.linalg.cholesky(_t(A))


@pytest.mark.parametrize("n", [4, 9])
def test_smallest_eigvec(rng, n):
    q, _ = np.linalg.qr(rng.normal(size=(5, n, n)))
    lam = np.concatenate([np.full((5, 1), 1e-3), rng.uniform(1.0, 3.0, (5, n - 1))], axis=1)
    S = ((q * lam[:, None, :]) @ q.transpose(0, 2, 1)).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda s: JM.smallest_eigvec(s, n))(jnp.asarray(S)))
    got = TM.smallest_eigvec(_t(S)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(np.abs((got * q[:, :, 0]).sum(1)), 1.0, atol=1e-4)


def test_inv3_and_polar_rotation(rng):
    M = rng.normal(size=(9, 3, 3)).astype(np.float32)
    M[0] = 0.0                                       # singular: the ε guard
    ref = np.asarray(jax.vmap(JM.inv3)(jnp.asarray(M)))
    np.testing.assert_allclose(TM.inv3(_t(M)).numpy()[1:], ref[1:], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(TM.inv3(_t(M)).numpy()[0], ref[0])
    ref = np.asarray(jax.vmap(JM.polar_rotation)(jnp.asarray(M[1:])))
    got = TM.polar_rotation(_t(M[1:])).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-4)


# ---------------------------------------------------------- solver parts

@pytest.fixture(scope="module")
def views():
    """8 noise-free views under the 5-coefficient camera, 6 of 16 points
    masked out in the odd frames."""
    rng = np.random.default_rng(7)
    rvec, tvec = _poses(rng, 8)
    img = _project(rvec, tvec)
    valid = np.ones((8, 16), bool)
    valid[1::2, [1, 4, 6, 9, 11, 14]] = False
    return rvec, tvec, img, valid


def test_dlt_homography_and_pose_init(views):
    rvec, tvec, img, valid = views
    w = valid.astype(np.float32)
    xn = np.asarray(JP.undistort_normalize(jnp.asarray(img), jnp.asarray(K),
                                           jnp.asarray(DISTS[5])))
    H_ref = np.asarray(jax.vmap(lambda x, ww: JS._dlt_homography(
        jnp.asarray(OBJ[:, :2]), x, ww))(jnp.asarray(xn), jnp.asarray(w)))
    H = TS._dlt_homography(_t(OBJ[:, :2]), _t(xn), _t(w)).numpy()
    # H's entries reach 1e2 (it maps metres to normalized coords); the null
    # vector comes from an f32 inverse iteration on a system whose condition
    # number is 1e6, hence 1e-3 relative to the largest entry
    np.testing.assert_allclose(H, H_ref, atol=1e-3 * np.abs(H_ref).max())
    R_ref, t_ref = jax.vmap(JS._pose_from_homography)(jnp.asarray(H_ref))
    R, t = TS._pose_from_homography(_t(H_ref))
    np.testing.assert_allclose(R.numpy(), np.asarray(R_ref), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=1e-5)
    c = (OBJ[None] * w[..., None]).sum(1) / w.sum(1, keepdims=True)
    R1_ref, _ = jax.vmap(JS._twin_pose)(R_ref, t_ref, jnp.asarray(c))
    R1, t1 = TS._twin_pose(_t(np.asarray(R_ref)), _t(np.asarray(t_ref)), _t(c))
    np.testing.assert_allclose(R1.numpy(), np.asarray(R1_ref), atol=1e-5)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(t_ref))


@pytest.mark.parametrize("iters", [1, 5])
def test_lm_refine_follows_the_jax_iterates(views, iters):
    rvec, tvec, img, valid = views
    rng = np.random.default_rng(3)
    w = valid.astype(np.float32)
    r0 = (rvec + rng.normal(scale=0.05, size=rvec.shape)).astype(np.float32)
    t0 = (tvec + rng.normal(scale=0.01, size=tvec.shape)).astype(np.float32)
    ref = jax.vmap(lambda i, ww, r, t: JS._lm_refine(
        jnp.asarray(OBJ), i, ww, jnp.asarray(K), jnp.asarray(DISTS[5]), r, t, iters=iters))(
        jnp.asarray(img), jnp.asarray(w), jnp.asarray(r0), jnp.asarray(t0))
    got = TS._lm_refine(_t(OBJ), _t(img), _t(w), _t(K), _t(DISTS[5]), _t(r0), _t(t0),
                        iters=iters)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-2, atol=1e-3)


# ------------------------------------------------------------ solve_pnp

_jax_solve = {}


def _jsolve(img, valid, k, dist, iters=20):
    """The JAX package's solve_pnp_batch on a batch of 8, one compilation per
    ``iters`` (the distortion vector always padded to 12)."""
    if iters not in _jax_solve:
        _jax_solve[iters] = jax.jit(lambda i, v, kk, d: JS.solve_pnp_batch(
            jnp.asarray(OBJ), i, v, kk, d, iters=iters))
    out = _jax_solve[iters](jnp.asarray(img), jnp.asarray(valid), jnp.asarray(k),
                            jnp.asarray(_pad12(dist)))
    return tuple(np.asarray(o) for o in out)


def _tsolve(img, valid, k, dist, iters=20):
    out = TS.solve_pnp_batch(_t(OBJ), _t(img), _t(valid), _t(k), _t(dist), iters=iters)
    return tuple(o.numpy() for o in out)


def _assert_same_solution(got, ref, rad=1e-3, rel=1e-3, px=1e-3):
    ok, r, t, rms = got
    ok_r, r_r, t_r, rms_r = ref
    np.testing.assert_array_equal(ok, ok_r)
    assert np.isfinite(r).all() and np.isfinite(t).all()
    np.testing.assert_allclose(r, r_r, atol=rad)
    assert (np.linalg.norm(t - t_r, axis=-1) <= rel * np.linalg.norm(t_r, axis=-1) + 1e-12).all()
    np.testing.assert_allclose(rms[ok_r], rms_r[ok_r], atol=px)
    assert np.isinf(rms[~ok_r]).all() and (r[~ok_r] == 0).all() and (t[~ok_r] == 0).all()


@pytest.fixture(scope="module")
def exact_case():
    rng = np.random.default_rng(42)
    rvec, tvec = _poses(rng, 8)
    img = _project(rvec, tvec)
    valid = np.ones((8, 16), bool)
    return rvec, tvec, img, valid, _jsolve(img, valid, K, DISTS[5]), \
        _tsolve(img, valid, K, DISTS[5])


@pytest.mark.parametrize("i", range(8))
def test_solve_pnp_recovers_exact_pose(exact_case, i):
    """The case of the JAX package's test of the same name, frame by frame:
    noise-free projections, its tolerances against the true pose, and the
    JAX result within 1e-3."""
    rvec, tvec, _, _, ref, got = exact_case
    ok, r, t, rms = (o[i] for o in got)
    assert ok and rms < 1e-2
    np.testing.assert_allclose(r, rvec[i], atol=5e-3)
    np.testing.assert_allclose(t, tvec[i], atol=2e-4)
    _assert_same_solution(tuple(o[i:i + 1] for o in got), tuple(o[i:i + 1] for o in ref))


@pytest.fixture(scope="module")
def noisy_case():
    rng = np.random.default_rng(43)
    rvec, tvec = _poses(rng, 8)
    img = (_project(rvec, tvec) + rng.normal(scale=0.5, size=(8, 16, 2))).astype(np.float32)
    valid = np.ones((8, 16), bool)
    return img, _jsolve(img, valid, K, DISTS[5], iters=30), \
        _tsolve(img, valid, K, DISTS[5], iters=30)


@pytest.mark.parametrize("i", range(8))
def test_solve_pnp_noisy_agrees_or_is_no_worse(noisy_case, i):
    """0.5 px noise, 30 iterations: the same pose as JAX's, or, where the
    two starts' costs tie within rounding and the other basin is picked, a
    reprojection error no larger than JAX's (the rule the JAX package's
    noisy test applies against cv2)."""
    img, ref, got = noisy_case
    ok, r, t, rms = (o[i] for o in got)
    ok_r, r_r, t_r, rms_r = (o[i] for o in ref)
    assert ok and ok_r
    same = np.allclose(r, r_r, atol=1e-3) and \
        np.linalg.norm(t - t_r) <= 1e-3 * np.linalg.norm(t_r)
    assert same or rms <= rms_r + 1e-4
    assert abs(rms - rms_r) <= 1e-3 or rms < rms_r


@pytest.fixture(scope="module")
def edge_cases():
    """One batch of 8 under the degenerate-input tests' camera: masked
    subset with garbage, too few points, coincident, collinear, NaN in
    invalid slots, exactly 4 points, 4 points of which 3 are collinear on
    the board, all invalid."""
    rng = np.random.default_rng(44)
    rvec, tvec = _poses(rng, 8)
    dist = np.zeros(5, np.float32)
    img = _project(rvec, tvec, K_DEG, dist)
    valid = np.ones((8, 16), bool)
    valid[0] = False
    valid[0, [0, 3, 5, 8, 12, 15]] = True
    img[0][~valid[0]] = -1e3
    valid[1] = False
    valid[1, [0, 1, 2]] = True
    img[1] = 0.0
    img[2] = 37.0
    img[3] = np.stack([np.linspace(10, 300, 16), np.linspace(10, 200, 16)], axis=1)
    valid[4, [2, 9]] = False
    img[4][~valid[4]] = np.nan
    valid[5] = False
    valid[5, [0, 3, 12, 15]] = True
    valid[6] = False
    valid[6, [0, 1, 2, 15]] = True
    valid[7] = False
    names = ["masked_subset", "too_few_points", "coincident", "collinear",
             "nan_in_invalid_slots", "four_points", "four_points_three_in_line",
             "all_invalid"]
    return names, rvec, tvec, _jsolve(img, valid, K_DEG, dist), _tsolve(img, valid, K_DEG, dist)


@pytest.mark.parametrize("i,name,want_ok", [
    (0, "masked_subset", True), (1, "too_few_points", False), (2, "coincident", False),
    (3, "collinear", False), (4, "nan_in_invalid_slots", True), (5, "four_points", True),
    (6, "four_points_three_in_line", None), (7, "all_invalid", False)])
def test_solve_pnp_edge_cases(edge_cases, i, name, want_ok):
    """The masked-subset, too-few-points and three degenerate-input cases of
    the JAX package's tests, and three more: ``ok`` equal to JAX's, finite
    outputs, zeros where it failed, and the pose within their tolerances."""
    names, rvec, tvec, ref, got = edge_cases
    assert names[i] == name
    ok, r, t, rms = (o[i] for o in got)
    if want_ok is not None:
        assert bool(ok) == want_ok
    _assert_same_solution(tuple(o[i:i + 1] for o in got), tuple(o[i:i + 1] for o in ref))
    if name == "masked_subset":
        np.testing.assert_allclose(r, rvec[i], atol=1e-2)
        np.testing.assert_allclose(t, tvec[i], atol=5e-4)
    if name == "nan_in_invalid_slots":
        np.testing.assert_allclose(r, rvec[i], atol=1e-3)


@pytest.mark.parametrize("n", [8, 12])
def test_solve_pnp_rational_model_roundtrip(rng, n):
    rvec, tvec = _poses(rng, 8)
    img = _project(rvec, tvec, dist=DISTS[n])
    valid = np.ones((8, 16), bool)
    got = _tsolve(img, valid, K, DISTS[n])
    assert got[0].all() and (got[3] < 1e-2).all()
    np.testing.assert_allclose(got[1], rvec, atol=1e-3)
    np.testing.assert_allclose(got[2], tvec, atol=1e-3)
    _assert_same_solution(got, _jsolve(img, valid, K, DISTS[n]))


def test_solve_pnp_single_frame_equals_its_row_in_a_batch(exact_case):
    _, _, img, valid, _, got = exact_case
    one = TS.solve_pnp(_t(OBJ), _t(img[2]), _t(valid[2]), _t(K), _t(DISTS[5]))
    assert one[0].shape == () and one[1].shape == (3,)
    for a, b in zip(one, got):
        np.testing.assert_allclose(a.numpy(), b[2], atol=1e-5)


def test_solve_pnp_on_cpu_tensors_is_the_plain_path_and_launches_nothing(exact_case,
                                                                       monkeypatch):
    """CPU tensors never reach the pose kernel: no library is built or
    loaded, no launch is counted, and the answer is ``solve_pnp_plain``'s,
    bit for bit."""
    from deepcharuco_tpu_torch import _build, profiling

    def refuse(name):
        raise AssertionError(f"the CPU path asked for the {name} kernel")

    monkeypatch.setattr(_build, "library", refuse)
    _, _, img, valid, _, _ = exact_case
    before = profiling.counters().get("kernels.pnp_launches", 0)
    got = TS.solve_pnp(_t(OBJ), _t(img), _t(valid), _t(K), _t(DISTS[5]))
    assert profiling.counters().get("kernels.pnp_launches", 0) == before
    want = TS.solve_pnp_plain(_t(OBJ), _t(img), _t(valid), _t(K), _t(DISTS[5]))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# --------------------------------------------------------------- ransac

@pytest.mark.parametrize("outliers", [0, 2])
def test_ransac_with_the_subsets_jax_drew(outliers):
    """The port cannot reproduce JAX's Gumbel stream, so the subsets JAX
    drew go in as weights: the same inliers, and the same pose to 1e-3."""
    rng = np.random.default_rng(45)
    n, s = 4, 16
    rvec, tvec = _poses(rng, n)
    img = (_project(rvec, tvec) + rng.normal(scale=0.05, size=(n, 16, 2))).astype(np.float32)
    valid = np.ones((n, 16), bool)
    valid[:, [3, 7]] = False
    for f in range(n):
        img[f, [f + 8, f + 12][:outliers]] += 25.0        # outliers among the valid points
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, n)
    ref = jax.vmap(lambda i, v, k: JR.solve_pnp_ransac(
        jnp.asarray(OBJ), i, v, jnp.asarray(K), jnp.asarray(DISTS[5]), k,
        n_hypotheses=s))(jnp.asarray(img), jnp.asarray(valid), keys)
    weights = np.asarray(jax.vmap(lambda k, v: jax.vmap(
        lambda kk: JR._sample_weights(kk, v, 16))(jax.random.split(k, s)))(
        keys, jnp.asarray(valid)))
    assert weights.shape == (n, s, 16) and (weights.sum(-1) == 4).all()
    got = TR.solve_pnp_ransac_from_weights(_t(OBJ), _t(img), _t(valid), _t(K),
                                           _t(DISTS[5]), _t(weights))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
    _assert_same_solution(tuple(o.numpy() for o in got[:4]),
                          tuple(np.asarray(o) for o in ref[:4]))
    if outliers:
        assert (got[4].numpy().sum(-1) <= 14 - outliers).all()


def test_ransac_draws_duplicate_free_subsets_from_a_generator():
    valid = torch.ones(3, 16, dtype=torch.bool)
    valid[1, 5:] = False
    valid[2, 2:] = False                            # fewer than 4 valid points
    g = torch.Generator().manual_seed(1)
    w = TR.sample_weights(valid, 16, generator=g)
    assert w.shape == (3, 16, 16)
    assert (w[:2].sum(-1) == 4).all() and (w[2].sum(-1) == 2).all()
    assert (w * (~valid)[:, None, :]).sum() == 0
    w2 = TR.sample_weights(valid, 16, generator=torch.Generator().manual_seed(1))
    assert torch.equal(w, w2)
    assert len({tuple(r.tolist()) for r in w[0]}) > 4


def test_ransac_batch_rejects_an_outlier():
    rng = np.random.default_rng(46)
    rvec, tvec = _poses(rng, 3)
    img = _project(rvec, tvec)
    img[:, 6] += 30.0
    valid = np.ones((3, 16), bool)
    ok, r, t, rms, inl = TR.solve_pnp_ransac_batch(
        _t(OBJ), _t(img), _t(valid), _t(K), _t(DISTS[5]),
        generator=torch.Generator().manual_seed(0), n_hypotheses=32)
    assert ok.all() and not inl[:, 6].any() and (inl.sum(-1) == 15).all()
    np.testing.assert_allclose(r.numpy(), rvec, atol=5e-3)
    np.testing.assert_allclose(t.numpy(), tvec, atol=5e-4)

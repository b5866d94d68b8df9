"""The port's geometry decode (``deepcharuco_tpu_torch.ops.geom``) against
the JAX package's, on the CPU; its way through the pipeline is in
``tests/test_torch_geom_pipeline.py``.

The same numpy inputs go through both, on the cases of
``tests/test_geom_decode.py``. The RANSAC seed's Gumbel tables are the ones
JAX draws from ``PRNGKey(0)``, passed into the port. Tolerances: ``valid``
and ``filled`` masks exact, positions within 1e-4 px (they are selected
candidates or rounded projections, so in fact equal), the seed's homography
within 1e-3 relative and its consensus count equal on every frame whose
points span a plane."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcharuco_tpu.ops import geom as jgeom
from deepcharuco_tpu_torch.ops import (fill_from_homography, pred_to_keypoints,
                                       pred_to_keypoints_geom, reselect_by_homography)
from deepcharuco_tpu_torch.ops import geom as tgeom

N_IDS = 16


@functools.lru_cache(maxsize=None)
def jax_noise(n_subsets, n_ids, capacity):
    """The Gumbel tables ``ops.geom._ransac_seed`` draws, as it draws them."""
    def draw(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.gumbel(k1, (n_ids,)), jax.random.gumbel(k2, (n_ids, capacity)))

    g, gs = jax.vmap(draw)(jax.random.split(jax.random.PRNGKey(0), n_subsets))
    return np.array(g), np.array(gs)


def noise_t(n_subsets, n_ids, capacity):
    return tuple(torch.from_numpy(t) for t in jax_noise(n_subsets, n_ids, capacity))


def _grid_and_true(seed=0):
    """A 4×4 board-plane grid and its image under a fixed homography."""
    ids = np.arange(N_IDS)
    bx = np.stack([ids % 4, ids // 4], -1).astype(np.float32)
    H = np.array([[20, 1.5, 30], [0.8, 19, 40], [0.001, 0, 1]], np.float32)
    p = bx @ H[:, :2].T + H[:, 2]
    return bx, (p[:, :2] / p[:, 2:]).astype(np.float32), np.random.default_rng(seed)


def _candidates(c=3):
    bx, true_px, rng = _grid_and_true()
    kp = np.zeros((N_IDS, c, 2), np.float32)
    val = np.zeros((N_IDS, c), bool)
    kp[:, 0] = true_px
    val[:, 0] = True
    return bx, true_px, rng, kp, val


def case_displaced_and_decoys():
    bx, true_px, rng, kp, val = _candidates()
    kp[5, 1], val[5, 1] = true_px[5], True              # the true corner in slot 1
    kp[5, 0] = true_px[5] + np.array([16, 8], np.float32)
    kp[9, 0] = true_px[9] + np.array([-24, 0], np.float32)   # only a decoy
    val[12] = False                                     # no candidate
    kp[val] += rng.normal(0, 0.5, kp[val].shape).astype(np.float32)
    return kp, val


def case_underdetermined():
    _, true_px, _, kp, val = _candidates()
    val[4:] = False                                     # 4 points: below min_points
    return kp, val


def case_three_ids():
    """Fewer than four ids hold a candidate: the seed's top-4 draw ties
    among the masked ids and must order them by index, as ``lax.top_k``."""
    _, _, _, kp, val = _candidates()
    val[:] = False
    val[[2, 7, 11], 0] = True
    val[7, 2] = True
    return kp, val


def case_collinear():
    _, _, _, kp, val = _candidates()
    kp[:], val[:] = 0, False
    for j in range(8):                                  # 8 detections on one board row
        kp[j, 0], val[j, 0] = (30 + 20 * j, 50), True
    return kp, val


def case_decoy_constellation():
    bx, true_px, rng, kp, val = _candidates()
    bad = [1, 3, 6, 10, 13]
    S = np.array([[1.1, 0.15], [0.05, 1.05]], np.float32)
    for b in bad:                                       # a coherent decoy plane
        kp[b, 0] = true_px[b] @ S.T + np.array([11.0, 7.0], np.float32)
    for b in bad[:2]:                                   # two keep the true corner below
        kp[b, 1], val[b, 1] = true_px[b], True
    kp[val] += rng.normal(0, 0.3, kp[val].shape).astype(np.float32)
    return kp, val


def case_random(seed):
    bx, true_px, _, kp, val = _candidates()
    rng = np.random.default_rng(seed)
    kp[:, 1:] = true_px[:, None] + rng.normal(0, 12, (N_IDS, 2, 2)).astype(np.float32)
    swap = rng.random(N_IDS) < 0.3                      # the true corner loses slot 0
    kp[swap, 0], kp[swap, 1] = kp[swap, 1].copy(), kp[swap, 0].copy()
    val[:, 1:] = rng.random((N_IDS, 2)) < 0.6
    val[rng.random(N_IDS) < 0.15] = False
    kp[val] += rng.normal(0, 0.4, kp[val].shape).astype(np.float32)
    return kp, val


CASES = {"displaced": case_displaced_and_decoys, "underdetermined": case_underdetermined,
         "three_ids": case_three_ids, "collinear": case_collinear,
         "decoys": case_decoy_constellation,
         **{f"random{i}": functools.partial(case_random, i) for i in range(3)}}


@functools.lru_cache(maxsize=None)
def jax_reselect_all(ransac_subsets=32):
    """Every case through the JAX function, one compilation for all."""
    bx = _grid_and_true()[0]
    kp, val = (np.stack(a) for a in zip(*(make() for make in CASES.values())))
    fn = jax.jit(jax.vmap(lambda a, b: jgeom.reselect_by_homography(
        a, b, jnp.asarray(bx), ransac_subsets=ransac_subsets)))
    out = fn(jnp.asarray(kp), jnp.asarray(val))
    return kp, val, np.asarray(out[0]), np.asarray(out[1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_reselect_matches_jax(case):
    kp, val, kp_ref, v_ref = jax_reselect_all()
    i = list(CASES).index(case)
    bx = torch.from_numpy(_grid_and_true()[0])
    got_kp, got_v = reselect_by_homography(torch.from_numpy(kp[i]), torch.from_numpy(val[i]),
                                           bx, noise=noise_t(32, N_IDS, 3))
    np.testing.assert_array_equal(got_v.numpy(), v_ref[i])
    np.testing.assert_allclose(got_kp.numpy()[v_ref[i]], kp_ref[i][v_ref[i]], atol=1e-4)


def test_reselect_is_batch_first():
    """All cases as one batch give each case's own result."""
    kp, val, kp_ref, v_ref = jax_reselect_all()
    bx = torch.from_numpy(_grid_and_true()[0])
    got_kp, got_v = reselect_by_homography(torch.from_numpy(kp), torch.from_numpy(val), bx,
                                           noise=noise_t(32, N_IDS, 3))
    np.testing.assert_array_equal(got_v.numpy(), v_ref)
    np.testing.assert_allclose(got_kp.numpy()[v_ref], kp_ref[v_ref], atol=1e-4)
    two = reselect_by_homography(torch.from_numpy(kp).reshape(2, -1, N_IDS, 3, 2),
                                 torch.from_numpy(val).reshape(2, -1, N_IDS, 3), bx,
                                 noise=noise_t(32, N_IDS, 3))
    np.testing.assert_array_equal(two[1].reshape(got_v.shape).numpy(), got_v.numpy())


def test_reselect_behaviour_on_the_reference_cases():
    """What ``tests/test_geom_decode.py`` asserts of the JAX function holds
    for the port's outputs (which equal JAX's, above)."""
    bx, true_px, _ = _grid_and_true()
    run = lambda make: tuple(t.numpy() for t in reselect_by_homography(
        *(torch.from_numpy(a) for a in make()), torch.from_numpy(bx),
        noise=noise_t(32, N_IDS, 3)))
    kp, v = run(case_displaced_and_decoys)
    d = np.linalg.norm(kp - true_px, axis=-1)
    others = [i for i in range(N_IDS) if i not in (5, 9, 12)]
    assert v[5] and d[5] < 3.0 and not v[9] and not v[12]
    assert v[others].all() and d[others].max() < 3.0
    kp_in, val_in = case_underdetermined()
    kp, v = run(case_underdetermined)
    np.testing.assert_array_equal(v, val_in[:, 0])
    np.testing.assert_array_equal(kp[:4], kp_in[:4, 0])
    kp_in, val_in = case_collinear()
    kp, v = run(case_collinear)
    assert (v | ~val_in[:, 0]).all()
    np.testing.assert_array_equal(kp[val_in[:, 0]], kp_in[val_in[:, 0], 0])
    kp, v = run(case_decoy_constellation)
    d = np.linalg.norm(kp - true_px, axis=-1)
    bad = [1, 3, 6, 10, 13]
    good = [i for i in range(N_IDS) if i not in bad]
    assert v[good].all() and d[good].max() < 3.0
    assert v[bad[:2]].all() and d[bad[:2]].max() < 3.0 and not v[bad[2:]].any()


def test_reselect_with_16_subsets_matches_jax():
    kp, val, kp_ref, v_ref = jax_reselect_all(ransac_subsets=16)
    got_kp, got_v = reselect_by_homography(
        torch.from_numpy(kp), torch.from_numpy(val), torch.from_numpy(_grid_and_true()[0]),
        ransac_subsets=16, noise=noise_t(16, N_IDS, 3))
    np.testing.assert_array_equal(got_v.numpy(), v_ref)
    np.testing.assert_allclose(got_kp.numpy()[v_ref], kp_ref[v_ref], atol=1e-4)


@pytest.mark.parametrize("gate", [float("inf"), 1.5])
def test_self_consistency_gate_matches_jax(gate):
    """A third of the constellation rides another plane; with one generous
    round and the least-squares seed only the final refit gate can catch it."""
    bx, true_px, _, kp, val = _candidates(2)
    for i, b in enumerate([1, 3, 6, 10, 13]):
        kp[b, 0] = true_px[b] + np.array([7.0 - 3 * i, 5.0 + 2 * i], np.float32)
    kw = dict(tol_px=16.0, iters=1, ransac_subsets=0)
    ref = jax.jit(lambda a, b, g: jgeom.reselect_by_homography(
        a, b, jnp.asarray(bx), max_rms_px=g, **kw))(jnp.asarray(kp), jnp.asarray(val), gate)
    got = reselect_by_homography(torch.from_numpy(kp), torch.from_numpy(val),
                                 torch.from_numpy(bx), max_rms_px=gate, **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4)
    if gate == 1.5:         # gated: the parity decode, exactly
        np.testing.assert_array_equal(got[1].numpy(), val[:, 0])
        np.testing.assert_array_equal(got[0].numpy(), kp[:, 0])
    else:
        assert got[1].numpy().sum() == N_IDS


def test_ransac_seed_matches_jax():
    """The seed alone, JAX's tables passed in: the same consensus count and
    the same homography (1e-3 relative: the two DLT solvers order their
    float32 sums differently); a degenerate frame scores zero inliers."""
    bx = _grid_and_true()[0]
    kp, val = (np.stack(a) for a in zip(*(make() for make in CASES.values())))
    H_ref, n_ref = jax.jit(jax.vmap(lambda a, b: jgeom._ransac_seed(
        a, b, jnp.asarray(bx), 32, 4.0)))(jnp.asarray(kp), jnp.asarray(val))
    H, n = tgeom._ransac_seed(torch.from_numpy(kp), torch.from_numpy(val),
                              torch.from_numpy(bx), 32, 4.0, noise_t(32, N_IDS, 3))
    n_ref = np.asarray(n_ref)
    # the collinear frame's best subset is a rank-deficient fit, whose
    # consensus hangs on the last bits of a near-singular solve
    fit = np.array([name != "collinear" for name in CASES])
    np.testing.assert_array_equal(n.numpy()[fit], n_ref[fit])
    good = fit & (n_ref >= 6)
    assert good.sum() >= 4
    np.testing.assert_allclose(H.numpy()[good], np.asarray(H_ref)[good], rtol=1e-3, atol=1e-3)
    nan_kp = torch.full((N_IDS, 3, 2), float("nan"))
    _, n_nan = tgeom._ransac_seed(nan_kp, torch.ones(N_IDS, 3, dtype=torch.bool),
                                  torch.from_numpy(bx), 32, 4.0)
    assert int(n_nan) == 0


def test_default_noise_is_seeded_and_checked():
    a, b = tgeom.default_noise(32, 16, 5), tgeom.default_noise(32, 16, 5)
    assert a[0].shape == (32, 16) and a[1].shape == (32, 16, 5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.isfinite(a[0]).all() and torch.isfinite(a[1]).all()
    kp, val = (torch.from_numpy(a) for a in case_displaced_and_decoys())
    bx = torch.from_numpy(_grid_and_true()[0])
    x, y = reselect_by_homography(kp, val, bx), reselect_by_homography(kp, val, bx)
    assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
    with pytest.raises(ValueError, match="noise tables"):
        reselect_by_homography(kp, val, bx, noise=noise_t(16, N_IDS, 3))


# ---------------------------------------------------------------- the fill

def _fill_cases():
    bx, true_px, rng = _grid_and_true()
    full = np.round(true_px)
    cases = {}
    kp, val = full.copy(), np.ones(N_IDS, bool)
    val[7], kp[7] = False, 0.0
    cases["dropped_corner"] = (kp, val, (240, 320), {})
    val = np.ones(N_IDS, bool)
    val[3] = False
    cases["out_of_frame"] = (full, val, (240, int(true_px[3, 0]) - 2), {})
    few = np.zeros(N_IDS, bool)
    few[:5] = True
    cases["underdetermined"] = (full, few, (240, 320), {})
    kp, val = full.copy(), np.ones(N_IDS, bool)
    val[7] = False
    kp[[1, 4, 10, 14]] += rng.uniform(6, 10, (4, 2)).astype(np.float32)
    cases["bad_fit"] = (kp, val, (240, 320), dict(min_spread_px=0.0))
    cases["good_fit"] = (full, val, (240, 320), dict(min_spread_px=0.0))
    kp, val = np.zeros((N_IDS, 2), np.float32), np.zeros(N_IDS, bool)
    for j in range(8):
        kp[j], val[j] = (30 + 18 * j, 60 + float(rng.normal(0, 0.2))), True
    cases["collinear"] = (kp, val, (240, 320), dict(max_rms_px=1e9))
    val = np.ones(N_IDS, bool)
    val[5], val[8:] = False, False
    cases["mahal_3"] = (full, val, (400, 500), dict(max_mahal=3.0, min_points=7))
    cases["mahal_off"] = (full, val, (400, 500), dict(max_mahal=1e9, min_points=7))
    return bx, true_px, cases


@functools.lru_cache(maxsize=None)
def _jax_fill():
    """One compilation: every parameter of the fill is a traced argument."""
    bx = jnp.asarray(_grid_and_true()[0])
    return jax.jit(lambda kp, v, h, w, mp, rms, spread, mahal: jgeom.fill_from_homography(
        kp, v, bx, (h, w), min_points=mp, max_rms_px=rms, min_spread_px=spread,
        max_mahal=mahal))


FILL_DEFAULTS = dict(min_points=8, max_rms_px=1.5, min_spread_px=3.0, max_mahal=3.0)


@pytest.mark.parametrize("case", sorted(_fill_cases()[2]))
def test_fill_matches_jax(case):
    bx, true_px, cases = _fill_cases()
    kp, val, hw, kw = cases[case]
    p = {**FILL_DEFAULTS, **kw}
    ref = _jax_fill()(jnp.asarray(kp), jnp.asarray(val), hw[0], hw[1], p["min_points"],
                      p["max_rms_px"], p["min_spread_px"], p["max_mahal"])
    centers_r, valid_r, filled_r = (np.asarray(o) for o in ref)
    centers, valid, filled = (t.numpy() for t in fill_from_homography(
        torch.from_numpy(kp), torch.from_numpy(val), torch.from_numpy(bx), hw, **kw))
    np.testing.assert_array_equal(valid, valid_r)
    np.testing.assert_array_equal(filled, filled_r)
    np.testing.assert_allclose(centers[valid_r], centers_r[valid_r], atol=1e-4)
    np.testing.assert_array_equal(centers[val], kp[val])      # detected ids untouched
    want = {"dropped_corner": [7], "out_of_frame": [], "underdetermined": [], "bad_fit": [],
            "good_fit": [7], "collinear": [], "mahal_3": [5]}
    if case in want:
        assert np.nonzero(filled)[0].tolist() == want[case]
    if case == "dropped_corner":
        assert np.linalg.norm(centers[7] - np.round(true_px[7])) <= 1.5
        assert (centers[7] == np.round(centers[7])).all()
    if case == "mahal_off":
        assert filled[12:].sum() >= 3 and filled[5]


def test_fill_is_batch_first():
    bx, _, cases = _fill_cases()
    same = [c for c in cases.values() if c[2] == (240, 320) and not c[3]]
    kp, val = np.stack([c[0] for c in same]), np.stack([c[1] for c in same])
    got = fill_from_homography(torch.from_numpy(kp), torch.from_numpy(val),
                               torch.from_numpy(bx), (240, 320))
    for i, c in enumerate(same):
        one = fill_from_homography(torch.from_numpy(c[0]), torch.from_numpy(c[1]),
                                   torch.from_numpy(bx), (240, 320))
        for a, b in zip(got, one):
            np.testing.assert_array_equal(a[i].numpy(), b.numpy())


# ------------------------------------------------------- heads → keypoints

def _maps_from_corners(true_px, hc=30, wc=40):
    """loc/ids head maps (logits) that decode exactly to ``true_px``."""
    loc = np.full((1, hc, wc, 65), -5.0, np.float32)
    ids = np.full((1, hc, wc, N_IDS + 1), -5.0, np.float32)
    loc[..., 64] = 5.0
    ids[..., N_IDS] = 5.0
    for i, (x, y) in enumerate(true_px):
        cx, cy = int(x) // 8, int(y) // 8
        pix = (int(y) % 8) * 8 + int(x) % 8
        loc[0, cy, cx, 64] = -5.0
        loc[0, cy, cx, pix] = 5.0
        ids[0, cy, cx, N_IDS] = -5.0
        ids[0, cy, cx, i] = 5.0 + 0.1 * i
    return loc, ids


def _head_cases():
    """Three frames: clean maps; one corner behind the loc gate; a decoy
    cell that outscores a true one."""
    bx, true_px, rng = _grid_and_true()
    true_px = np.round(true_px)
    clean = _maps_from_corners(true_px)
    loc, ids = (a.copy() for a in clean)
    x, y = true_px[10]
    loc[0, int(y) // 8, int(x) // 8, 64] = 6.0          # the loc gate fires on id 10
    gated = (loc, ids)
    loc, ids = (a.copy() for a in clean)
    loc[0, 2, 30, 64], loc[0, 2, 30, 9] = -5.0, 5.0     # a far cell claims id 6, louder
    ids[0, 2, 30, N_IDS], ids[0, 2, 30, 6] = -5.0, 9.0
    decoy = (loc, ids)
    loc, ids = (np.concatenate(a) for a in zip(clean, gated, decoy))
    return bx, true_px, loc, ids


def test_pred_to_keypoints_geom_matches_jax():
    bx, true_px, loc, ids = _head_cases()
    ref = jax.jit(lambda a, b: jgeom.pred_to_keypoints_geom(a, b, N_IDS, jnp.asarray(bx)))(
        jnp.asarray(loc), jnp.asarray(ids))
    kp_r, v_r = np.asarray(ref[0]), np.asarray(ref[1])
    tl, ti, tb = torch.from_numpy(loc), torch.from_numpy(ids), torch.from_numpy(bx)
    kp, v = (t.numpy() for t in pred_to_keypoints_geom(tl, ti, N_IDS, tb,
                                                       noise=noise_t(32, N_IDS, 5)))
    np.testing.assert_array_equal(v, v_r)
    np.testing.assert_allclose(kp[v_r], kp_r[v_r], atol=1e-4)
    # clean input: the parity decode
    kp_p, v_p = (t.numpy() for t in pred_to_keypoints(tl, ti, N_IDS))
    np.testing.assert_array_equal(v[0], v_p[0])
    np.testing.assert_array_equal(kp[0], kp_p[0])
    # the loc-gated corner: dropped by the parity decode, recovered here,
    # and dropped again without the override
    assert not v_p[1, 10] and v[1, 10]
    np.testing.assert_allclose(kp[1, 10], true_px[10], atol=1.0)
    _, v_n = pred_to_keypoints_geom(tl, ti, N_IDS, tb, loc_override=False,
                                    noise=noise_t(32, N_IDS, 3))
    assert not v_n.numpy()[1, 10]
    # the louder decoy takes id 6 in the parity decode and loses it here
    assert kp_p[2, 6].tolist() == [241.0, 17.0]
    np.testing.assert_array_equal(kp[2, 6], true_px[6])

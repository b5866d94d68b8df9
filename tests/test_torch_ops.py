"""The port's image, patch and decode ops against the JAX package's, on the
same numpy inputs: exact, but for the soft-argmax decode (a softmax and two
sums in float32, ≤ 1e-4 px)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcharuco_tpu import ops as J
from deepcharuco_tpu.ops import decode as JD
from deepcharuco_tpu_torch import ops as T

N_IDS = 16


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_image_ops_exact(rng):
    bgr = rng.integers(0, 256, (2, 6, 8, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (2, 6, 8), dtype=np.uint8)
    np.testing.assert_array_equal(T.bgr_to_gray(_t(bgr)).numpy(),
                                  np.asarray(J.bgr_to_gray(jnp.asarray(bgr))))
    np.testing.assert_array_equal(T.normalize_gray(_t(gray)).numpy(),
                                  np.asarray(J.normalize_gray(jnp.asarray(gray))))
    np.testing.assert_array_equal(T.preprocess_bgr(_t(bgr)).numpy(),
                                  np.asarray(J.preprocess_bgr(jnp.asarray(bgr))))
    x = rng.normal(size=(2, 6, 8, 1)).astype(np.float32)
    np.testing.assert_array_equal(T.downsample2x(_t(x)).numpy(),
                                  np.asarray(J.downsample2x(jnp.asarray(x))))
    with pytest.raises(ValueError):
        T.downsample2x(torch.zeros(1, 5, 8, 1))


@pytest.mark.parametrize("patch_size", [24, 8])
def test_extract_patches_exact_with_border_and_out_of_range(rng, patch_size):
    gray = rng.normal(size=(2, 40, 56, 1)).astype(np.float32)
    kp = np.array([[[0, 0], [55, 39], [3.7, 20.2], [-5, 10], [60, 45], [28, 0]],
                   [[10, 30], [55, 0], [0, 39], [100, -100], [27.9, 19.5], [1, 1]]],
                  np.float32)
    ref = J.extract_patches(jnp.asarray(gray), jnp.asarray(kp), patch_size)
    got = T.extract_patches(_t(gray), _t(kp), patch_size)
    assert got.shape == (2, 6, patch_size, patch_size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got3 = T.extract_patches(_t(gray[..., 0]), _t(kp), patch_size)
    np.testing.assert_array_equal(got3.numpy(), np.asarray(ref))


def _logits(rng, kind, n=3, hc=6, wc=8):
    loc = rng.normal(size=(n, hc, wc, 65)).astype(np.float32)
    ids = rng.normal(size=(n, hc, wc, N_IDS + 1)).astype(np.float32)
    if kind == "ties":
        # confidences on a coarse grid: duplicate-id claims with equal
        # confidence, and first-max ties inside a cell
        ids = np.round(ids * 2) / 2
        loc = np.round(loc)
    elif kind == "dustbin":
        loc[0, ..., 64] = 10.0
    return loc, ids


@pytest.mark.parametrize("kind", ["random", "ties", "dustbin"])
@pytest.mark.parametrize("min_margin", [None, 0.5])
def test_pred_to_keypoints_exact(rng, kind, min_margin):
    loc, ids = _logits(rng, kind)
    kr, vr = J.pred_to_keypoints(jnp.asarray(loc), jnp.asarray(ids), N_IDS,
                                 min_margin=min_margin)
    kp, v = T.pred_to_keypoints(_t(loc), _t(ids), N_IDS, min_margin=min_margin)
    vr = np.asarray(vr)
    np.testing.assert_array_equal(v.numpy(), vr)
    # valid slots only: invalid ones hold (0, 0) here, cell 0's position in jnp
    np.testing.assert_array_equal(kp.numpy()[vr], np.asarray(kr)[vr])
    assert (kp.numpy()[~vr] == 0).all()
    if kind == "dustbin":
        assert not v[0].any()


def test_pred_argmax_and_label_to_keypoints_exact(rng):
    loc, ids = _logits(rng, "ties")
    la, ia = J.pred_argmax(jnp.asarray(loc), jnp.asarray(ids), N_IDS)
    tla, tia = T.pred_argmax(_t(loc), _t(ids), N_IDS)
    np.testing.assert_array_equal(tla.numpy(), np.asarray(la))
    np.testing.assert_array_equal(tia.numpy(), np.asarray(ia))
    # no scores: the last row-major cell wins among duplicates
    kr, vr = J.label_to_keypoints(la, ia, N_IDS)
    kp, v = T.label_to_keypoints(tla, tia, N_IDS)
    np.testing.assert_array_equal(v.numpy(), np.asarray(vr))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kr))


@pytest.mark.parametrize("trailing_channel", [False, True])
def test_refine_keypoints_exact(rng, trailing_channel):
    heat = rng.normal(size=(2, 5, 64, 64)).astype(np.float32)
    heat[0, 0] = 1.0  # all-equal map: first max
    heat[1, 2, 10, 3] = heat[1, 2, 40, 50] = 99.0  # tie: first in row-major order
    if trailing_channel:
        heat = heat[..., None]
    kp = rng.integers(0, 300, (2, 5, 2)).astype(np.float32)
    ref = J.refine_keypoints(jnp.asarray(heat), jnp.asarray(kp))
    got = T.refine_keypoints(_t(heat), _t(kp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        T.heatmap_argmax2d(_t(heat[..., 0] if trailing_channel else heat)).numpy(),
        np.asarray(J.heatmap_argmax2d(jnp.asarray(heat[..., 0] if trailing_channel
                                                  else heat))))


@pytest.mark.parametrize("trailing_channel", [False, True])
@pytest.mark.parametrize("temperature", [30.0, 5.0])
def test_soft_decodes_within_1e_4_px(rng, trailing_channel, temperature):
    heat = rng.uniform(0, 1, size=(2, 5, 64, 64)).astype(np.float32)
    heat[0, 0] = 0.5                                  # flat map: the grid's center
    heat[1, 2, 10, 3] = heat[1, 2, 40, 50] = 3.0      # two equal peaks: between them
    if trailing_channel:
        heat = heat[..., None]
    kp = rng.integers(0, 300, (2, 5, 2)).astype(np.float32)
    ref = JD.soft_argmax_2d(jnp.asarray(heat), temperature)
    got = T.soft_argmax_2d(_t(heat), temperature)
    assert got.shape == (2, 5, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=8e-4)   # grid units: 1/8 px
    ref = J.refine_keypoints_soft(jnp.asarray(heat), jnp.asarray(kp), temperature)
    got = T.refine_keypoints_soft(_t(heat), _t(kp), temperature)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_refine_keypoints_offset_exact(rng):
    kp = rng.integers(0, 300, (2, 5, 2)).astype(np.float32)
    off = rng.normal(size=(2, 5, 2)).astype(np.float32)
    ref = J.refine_keypoints_offset(jnp.asarray(off), jnp.asarray(kp))
    np.testing.assert_array_equal(T.refine_keypoints_offset(_t(off), _t(kp)).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("kind", ["random", "ties", "dustbin"])
@pytest.mark.parametrize("capacity", [1, 4])
@pytest.mark.parametrize("min_margin", [None, 0.5])
def test_pred_to_keypoints_topk_exact(rng, kind, capacity, min_margin):
    """Equal confidences (the "ties" logits sit on a coarse grid) order by
    ascending cell, as ``jax.lax.top_k`` orders them: every slot is exact,
    the empty ones too (both fill them from the lowest cells)."""
    loc, ids = _logits(rng, kind)
    kr, vr = J.pred_to_keypoints_topk(jnp.asarray(loc), jnp.asarray(ids), N_IDS,
                                      capacity=capacity, min_margin=min_margin)
    kp, v = T.pred_to_keypoints_topk(_t(loc), _t(ids), N_IDS, capacity=capacity,
                                     min_margin=min_margin)
    assert kp.shape == (3, N_IDS, capacity, 2) and v.shape == (3, N_IDS, capacity)
    np.testing.assert_array_equal(v.numpy(), np.asarray(vr))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kr))
    # slot 0 is the one-slot decode's winner
    k1, v1 = T.pred_to_keypoints(_t(loc), _t(ids), N_IDS, min_margin=min_margin)
    np.testing.assert_array_equal(v[:, :, 0].numpy(), v1.numpy())
    np.testing.assert_array_equal(kp[:, :, 0][v1].numpy(), k1[v1].numpy())
    if kind == "ties":
        assert v.numpy().sum() > v1.numpy().sum() or capacity == 1


def test_label_to_keypoints_topk_forced_ties_exact():
    """Five cells claim id 3 with one score and three claim id 5 with two
    scores: slots fill by score, then by ascending cell; with no scores the
    highest cell comes first."""
    loc = np.tile(np.arange(48, dtype=np.int32).reshape(1, 6, 8) % 64, (2, 1, 1))
    ids = np.full((2, 6, 8), N_IDS, np.int32)
    scores = np.zeros((2, 6, 8), np.float32)
    for cell in (41, 7, 30, 12, 19):
        ids[:, cell // 8, cell % 8] = 3
        scores[:, cell // 8, cell % 8] = 2.5
    for cell, sc in ((5, 1.0), (20, 4.0), (2, 1.0)):
        ids[:, cell // 8, cell % 8] = 5
        scores[:, cell // 8, cell % 8] = sc
    for sc in (scores, None):
        kr, vr = JD.label_to_keypoints_topk(jnp.asarray(loc), jnp.asarray(ids), N_IDS,
                                           capacity=4,
                                           scores=None if sc is None else jnp.asarray(sc))
        kp, v = T.label_to_keypoints_topk(_t(loc), _t(ids), N_IDS, capacity=4,
                                          scores=None if sc is None else _t(sc))
        np.testing.assert_array_equal(v.numpy(), np.asarray(vr))
        np.testing.assert_array_equal(kp.numpy(), np.asarray(kr))
    cell_of = lambda xy: int(xy[1] // 8) * 8 + int(xy[0] // 8)
    kp, v = T.label_to_keypoints_topk(_t(loc), _t(ids), N_IDS, capacity=4, scores=_t(scores))
    assert [cell_of(xy) for xy in kp[0, 3]] == [7, 12, 19, 30] and v[0, 3].all()
    assert [cell_of(xy) for xy in kp[0, 5][:3]] == [20, 2, 5]
    assert v[0, 5].tolist() == [True, True, True, False] and not v[0, 0].any()


@pytest.mark.parametrize("shape", [(480, 640), (37, 53)])
def test_extract_patches_32px_exact_on_larger_frames(rng, shape):
    """The 32-px patches of the hi-res tap, centers on and beyond every edge."""
    h, w = shape
    gray = rng.normal(size=(2, h, w)).astype(np.float32)
    kp = np.stack([rng.uniform(-20, w + 20, (2, 16)), rng.uniform(-20, h + 20, (2, 16))],
                  axis=-1).astype(np.float32)
    kp[0, :4] = [[0, 0], [w - 1, h - 1], [w - 1, 0], [0, h - 1]]
    ref = J.extract_patches(jnp.asarray(gray), jnp.asarray(kp), 32)
    got = T.extract_patches(_t(gray), _t(kp), 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

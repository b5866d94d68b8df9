"""The port's image, patch and decode ops against the JAX package's, on the
same numpy inputs: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcharuco_tpu import ops as J
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

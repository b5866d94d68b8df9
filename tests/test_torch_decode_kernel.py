"""The decode kernel's plain version (``ops/cuda_decode.py``) against the
Pallas kernel it replaces, run in interpret mode: exact, invalid slots
included (both write (0, 0) there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcharuco_tpu.ops import pred_to_keypoints as jnp_pred_to_keypoints
from deepcharuco_tpu.ops.pallas_decode import pallas_pred_to_keypoints
from deepcharuco_tpu_torch import profiling
from deepcharuco_tpu_torch.ops import cuda_decode

N_IDS = 16


def _logits(rng, kind):
    loc = rng.normal(size=(2, 30, 40, 65)).astype(np.float32)
    ids = rng.normal(size=(2, 30, 40, N_IDS + 1)).astype(np.float32)
    if kind == "dustbin":
        loc[..., 64] = 10.0
    elif kind == "ties":
        ids = np.round(ids * 2) / 2
    return loc, ids


@pytest.mark.parametrize("kind", ["random", "ties", "dustbin"])
def test_decode_plain_matches_pallas_kernel(rng, kind):
    loc, ids = _logits(rng, kind)
    kr, vr = pallas_pred_to_keypoints(jnp.asarray(loc), jnp.asarray(ids), N_IDS,
                                      interpret=True)
    kp, v = cuda_decode.decode_plain(torch.from_numpy(loc), torch.from_numpy(ids), N_IDS)
    np.testing.assert_array_equal(v.numpy(), np.asarray(vr))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kr))
    if kind == "dustbin":
        assert not v.any()


@pytest.mark.parametrize("min_margin", [0.5, 2.0])
def test_decode_plain_min_margin_matches_jnp(rng, min_margin):
    loc, ids = _logits(rng, "random")
    kr, vr = jnp_pred_to_keypoints(jnp.asarray(loc), jnp.asarray(ids), N_IDS,
                                   min_margin=min_margin)
    kp, v = cuda_decode.decode_plain(torch.from_numpy(loc), torch.from_numpy(ids), N_IDS,
                                     min_margin=min_margin)
    vr = np.asarray(vr)
    np.testing.assert_array_equal(v.numpy(), vr)
    np.testing.assert_array_equal(kp.numpy()[vr], np.asarray(kr)[vr])
    assert (kp.numpy()[~vr] == 0).all()


def test_decode_wrapper_runs_plain_version_on_cpu_without_launching(rng):
    loc, ids = _logits(rng, "random")
    before = profiling.counters().get("kernels.b1_launches", 0)
    kp, v = cuda_decode.decode(torch.from_numpy(loc), torch.from_numpy(ids), N_IDS)
    kq, w = cuda_decode.decode_plain(torch.from_numpy(loc), torch.from_numpy(ids), N_IDS)
    assert profiling.counters().get("kernels.b1_launches", 0) == before
    assert torch.equal(kp, kq) and torch.equal(v, w)

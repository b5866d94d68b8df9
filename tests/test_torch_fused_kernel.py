"""The fused head + decode kernel's fold and plain version
(``ops/cuda_fused.py``) against the Pallas kernel it replaces, run in
interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcharuco_tpu.models import Detector as JDetector
from deepcharuco_tpu.ops.pallas_fused import fold_head_params as jfold
from deepcharuco_tpu.ops.pallas_fused import pallas_fused_head_decode
from deepcharuco_tpu.pipeline import variables_from_npz
from deepcharuco_tpu_torch import profiling
from deepcharuco_tpu_torch.ops import cuda_fused

N_IDS = 16


def _variables(source):
    if source == "shipped":
        return variables_from_npz("artifacts/detector_devsynth.npz")
    v = JDetector(n_ids=N_IDS).init(jax.random.PRNGKey(7), jnp.zeros((1, 48, 64, 1)))
    return jax.tree.map(np.asarray, v)


def _trunk(source, rng):
    if source == "random":
        return rng.normal(size=(2, 30, 40, 128)).astype(np.float32)
    # trained heads claim nothing on a trunk of plain random numbers: use
    # ReLU-like features with lognormal spread instead
    base = np.load("tests/data/torch_port_frames.npz")["frames"][:2]
    v = variables_from_npz("artifacts/detector_devsynth.npz")
    g = (base.astype(np.float32) - 128.0) / 255.0
    t = JDetector(n_ids=N_IDS, dtype=jnp.float32).apply(v, jnp.asarray(g[..., None]),
                                                         trunk_only=True)["trunk"]
    return np.asarray(t) * np.exp(0.3 * rng.normal(size=t.shape)).astype(np.float32)


@pytest.mark.parametrize("source", ["shipped", "random"])
def test_fold_head_params_exact(source):
    v = _variables(source)
    ref = jfold(v, N_IDS)
    got = cuda_fused.fold_head_params(v, N_IDS)
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        value = np.asarray(value)
        assert tuple(got[key].shape) == value.shape, key
        want_dtype = torch.bfloat16 if value.dtype == jnp.bfloat16 else torch.float32
        assert got[key].dtype == want_dtype, key
        np.testing.assert_array_equal(got[key].float().numpy(), value.astype(np.float32),
                                      err_msg=key)


@pytest.mark.parametrize("source", ["shipped", "random"])
@pytest.mark.parametrize("min_margin", [None, 2.0])
def test_fused_plain_matches_pallas_kernel(rng, source, min_margin):
    v = _variables(source)
    trunk = _trunk(source, rng)
    kr, vr = pallas_fused_head_decode(jnp.asarray(trunk), jfold(v, N_IDS), N_IDS,
                                      min_margin=min_margin, interpret=True)
    kp, valid = cuda_fused.fused_head_decode_plain(
        torch.from_numpy(trunk), cuda_fused.fold_head_params(v, N_IDS), N_IDS,
        min_margin=min_margin)
    vr = np.asarray(vr)
    assert vr.sum() >= 8, "the case must exercise claims"
    np.testing.assert_array_equal(valid.numpy(), vr)
    np.testing.assert_array_equal(kp.numpy()[vr], np.asarray(kr)[vr])
    assert (kp.numpy()[~vr] == 0).all()


@pytest.mark.parametrize("params", ["fold", "head_params"])
def test_fused_wrapper_runs_plain_version_on_cpu_without_launching(rng, params):
    v = _variables("shipped")
    trunk = torch.from_numpy(_trunk("shipped", rng))
    folded = cuda_fused.fold_head_params(v, N_IDS)
    given = folded if params == "fold" else cuda_fused.head_params(v, N_IDS)
    before = profiling.counters().get("kernels.b2_launches", 0)
    kp, valid = cuda_fused.fused_head_decode(trunk, given, N_IDS)
    kq, w = cuda_fused.fused_head_decode_plain(trunk, folded, N_IDS)
    assert profiling.counters().get("kernels.b2_launches", 0) == before
    assert torch.equal(kp, kq) and torch.equal(valid, w)


@pytest.mark.parametrize("source", ["shipped", "random"])
def test_packed_weights_unpack_bit_exact(source):
    folded = cuda_fused.fold_head_params(_variables(source), N_IDS)
    packed = cuda_fused.pack_head_params(folded)
    assert packed["whT"].is_contiguous() and packed["whT"].shape == (512, 9 * 128)
    assert not packed["wpbT"][65:].any() and not packed["wdbT"][N_IDS + 1:].any()
    back = cuda_fused.unpack_head_weights(packed, N_IDS)
    for key, value in back.items():
        assert value.dtype == folded[key].dtype and value.shape == folded[key].shape, key
        assert torch.equal(value.view(torch.int16) if value.dtype == torch.bfloat16
                           else value, folded[key].view(torch.int16)
                           if value.dtype == torch.bfloat16 else folded[key]), key

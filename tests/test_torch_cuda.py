"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips (from inside the test, via the ``card``
fixture) where there is no CUDA device. On a machine with an H100 and the
CUDA toolkit: ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from deepcharuco_tpu_torch.ops import cuda_decode, cuda_fused
from deepcharuco_tpu_torch.ops.image import normalize_gray
from deepcharuco_tpu_torch.weights import load_detector, variables_from_npz

pytestmark = pytest.mark.cuda
N_IDS = 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("min_margin", [None, 0.5])
def test_decode_kernel_matches_plain(card, rng, min_margin):
    loc = rng.normal(size=(4, 30, 40, 65)).astype(np.float32)
    ids = np.round(rng.normal(size=(4, 30, 40, N_IDS + 1)) * 2).astype(np.float32) / 2
    loc[0, ..., 64] = 10.0
    loc_t, ids_t = torch.from_numpy(loc).to(card), torch.from_numpy(ids).to(card)
    before = cuda_decode.launches
    kk, vk = cuda_decode.decode(loc_t, ids_t, N_IDS, min_margin)
    kp, vp = cuda_decode.decode_plain(loc_t, ids_t, N_IDS, min_margin)
    torch.cuda.synchronize()
    assert cuda_decode.launches == before + 1
    assert torch.equal(vk, vp) and torch.equal(kk, kp)
    assert not vk[0].any()


@pytest.mark.parametrize("min_margin", [None, 2.0])
def test_fused_kernel_matches_plain(card, rng, min_margin):
    folded = {k: v.to(card) for k, v in cuda_fused.fold_head_params(
        variables_from_npz("artifacts/detector_devsynth.npz"), N_IDS).items()}
    frames = torch.from_numpy(np.load("tests/data/torch_port_frames.npz")["frames"][:4])
    det = load_detector("artifacts/detector_devsynth.npz").to(card)
    with torch.inference_mode():
        trunk = det(normalize_gray(frames.to(card)), trunk_only=True)["trunk"]
    noise = np.exp(0.3 * rng.normal(size=tuple(trunk.shape))).astype(np.float32)
    trunk = (trunk.float() * torch.from_numpy(noise).to(card)).to(torch.bfloat16)
    before = cuda_fused.launches
    kk, vk = cuda_fused.fused_head_decode(trunk, folded, N_IDS, min_margin)
    kp, vp = cuda_fused.fused_head_decode_plain(trunk, folded, N_IDS, min_margin)
    torch.cuda.synchronize()
    assert cuda_fused.launches == before + 1
    # the kernel and the plain version sum in different orders: near-ties
    # may flip, at most 0.5% of slots
    assert vp.sum() >= 16
    assert (vk != vp).float().mean() <= 0.005
    both = vk & vp
    assert (((kk - kp).abs().amax(-1) > 0) & both).float().mean() <= 0.005


def test_wrappers_reject_bad_inputs(card):
    loc = torch.zeros(1, 30, 40, 65, device=card)
    with pytest.raises(ValueError):
        cuda_decode.decode(loc.double(), torch.zeros(1, 30, 40, 17, device=card), N_IDS)
    with pytest.raises(ValueError):
        cuda_fused.fused_head_decode(torch.zeros(1, 30, 40, 128, device=card), {}, N_IDS)

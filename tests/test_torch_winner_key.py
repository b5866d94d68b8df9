"""The 64-bit winner key that both CUDA kernels reduce across blocks
(``csrc/decode_common.cuh``), stated in plain PyTorch by
``cuda_decode.winner_keys_plain``: reducing by key and turning the winning
keys back into keypoints must give exactly ``decode_plain``'s result, ties
and signed zeros included."""

import struct

import numpy as np
import pytest
import torch

from deepcharuco_tpu_torch.ops import cuda_decode, cuda_fused

N_IDS = 16


def _logits(rng, case):
    hc, wc = (135, 240) if case == "grid_135x240" else (30, 40)
    n = 1 if case == "grid_135x240" else 3
    loc = rng.normal(size=(n, hc, wc, 65)).astype(np.float32)
    ids = rng.normal(size=(n, hc, wc, N_IDS + 1)).astype(np.float32)
    if case == "ties":
        ids = np.round(ids * 2) / 2
    elif case == "dustbin":
        loc[0, ..., 64] = 10.0
    elif case == "signed_zero":
        # id 3 is claimed with confidence −0.0 by a lower cell and +0.0 by a
        # higher one: equal confidences, so the lower cell must win
        ids[:] = -5.0
        loc[..., 64] = -10.0
        for cell, zero in ((517, -0.0), (902, 0.0), (1100, -0.0)):
            r, c = divmod(cell, wc)
            ids[:, r, c, 3] = zero
    return loc, ids


def _ordered(x: float) -> int:
    u = struct.unpack("<I", struct.pack("<f", 0.0 if x == 0 else x))[0]
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000


@pytest.mark.parametrize("min_margin", [None, 0.5, 2.0])
@pytest.mark.parametrize("case", ["random", "ties", "dustbin", "signed_zero",
                                  "grid_135x240"])
def test_reducing_by_key_equals_decode_plain(rng, case, min_margin):
    loc, ids = (torch.from_numpy(a) for a in _logits(rng, case))
    keys = cuda_decode.winner_keys_plain(loc, ids, N_IDS, min_margin)
    assert keys.shape == (loc.shape[0], N_IDS) and keys.dtype == torch.int64
    kp, v = cuda_decode.keys_to_keypoints(keys, loc.shape[2])
    kr, vr = cuda_decode.decode_plain(loc, ids, N_IDS, min_margin)
    assert torch.equal(v, vr)
    assert torch.equal(kp, kr)
    if case == "dustbin":
        assert not v[0].any()
    if case == "signed_zero":
        assert bool(v[:, 3].all())
        r, c = divmod(517, 40)
        pix = int(np.argmax(loc[0, r, c].numpy()))
        assert kp[0, 3].tolist() == [8 * c + pix % 8, 8 * r + pix // 8]
    else:
        assert bool(v.any())


@pytest.mark.parametrize("conf", [1.5, -2.25, 0.0, -0.0, 3.0e38, -3.0e38])
def test_key_layout(conf):
    """One claiming cell: its key is the documented bit layout, stored with
    the top bit flipped."""
    hc, wc, cell, pix, cid = 4, 5, 13, 42, 7
    loc = torch.full((1, hc, wc, 65), -1.0)
    ids = torch.full((1, hc, wc, N_IDS + 1), -float("inf"))
    ids[..., N_IDS] = 0.0                       # every other cell: dustbin id
    r, c = divmod(cell, wc)
    loc[0, r, c, pix] = 1.0
    ids[0, r, c, N_IDS] = -float("inf")
    ids[0, r, c, cid] = conf
    keys = cuda_decode.winner_keys_plain(loc, ids, N_IDS)
    want = (_ordered(conf) << 32) | (((1 << 24) - 1 - cell) << 8) | pix
    assert int(keys[0, cid]) == want - (1 << 63)
    assert (keys[0, torch.arange(N_IDS) != cid] == cuda_decode.NO_CLAIM).all()


def test_key_order_follows_confidence_then_lower_cell(rng):
    confs = np.sort(rng.normal(size=64).astype(np.float32))
    u = np.array([_ordered(float(x)) for x in confs], dtype=np.uint64)
    assert (np.diff(u.astype(np.float64)) >= 0).all()
    assert _ordered(0.0) == _ordered(-0.0) > _ordered(-1e-30)
    low = lambda cell: (1 << 24) - 1 - cell
    assert low(3) > low(4)


def test_wrappers_refuse_2_pow_24_cells():
    big = 1 << 12                               # 4096 × 4096 cells = 2**24
    loc = torch.zeros(1, 1, 1, 65).expand(1, big, big, 65)
    ids = torch.zeros(1, 1, 1, N_IDS + 1).expand(1, big, big, N_IDS + 1)
    with pytest.raises(ValueError, match="24-bit"):
        cuda_decode.decode(loc, ids, N_IDS)
    trunk = torch.zeros(1, 1, 1, 128, dtype=torch.bfloat16).expand(1, big, big, 128)
    with pytest.raises(ValueError, match="24-bit"):
        cuda_fused.fused_head_decode(trunk, {}, N_IDS)
    cuda_decode.check_cells(big, big - 1)       # one row fewer fits

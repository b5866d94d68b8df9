"""Corner decode kernel (``csrc/decode.cu``) and its plain version.

The CUDA counterpart of ``deepcharuco_tpu.ops.pallas_decode.
pallas_pred_to_keypoints``: loc logits (N, Hc, Wc, 65) and ids logits
(N, Hc, Wc, n_ids+1) → keypoints (N, n_ids, 2) float32 and valid
(N, n_ids) bool, with the optional ``min_margin`` gate of the fused kernel.
Invalid slots hold (0, 0).

:func:`decode` launches the kernel for CUDA tensors and runs
:func:`decode_plain` for CPU tensors; nothing else chooses between them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deepcharuco_tpu_torch import _build

launches = 0  # kernel launches since the last reset (see chip_smoke.py)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    lib = _build.library("decode")
    fn = lib.dc_decode
    fn.argtypes = [_P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P, _P, _P]
    fn.restype = _I
    return lib, fn


def decode_plain(loc_hat: torch.Tensor, ids_hat: torch.Tensor, n_ids: int,
                 min_margin: Optional[float] = None):
    """The kernel's function in plain PyTorch (same contract, same device)."""
    n, hc, wc, _ = loc_hat.shape
    m = hc * wc
    loc = loc_hat.reshape(n, m, -1).float()
    ids = ids_hat.reshape(n, m, -1).float()
    loc_pix = torch.argmax(loc, dim=-1)                     # (N, M)
    conf = ids.amax(dim=-1)
    ids_arg = torch.argmax(ids, dim=-1)                     # first max
    claim = (loc_pix != 64) & (ids_arg != n_ids)
    if min_margin is not None:
        claim &= (conf - ids[..., n_ids]) >= min_margin
    mine = claim[:, None, :] & (ids_arg[:, None, :] ==
                                torch.arange(n_ids, device=loc.device)[None, :, None])
    score = torch.where(mine, conf[:, None, :],
                        torch.tensor(float("-inf"), device=loc.device))
    best = torch.argmax(score, dim=-1)                      # (N, n_ids), lowest cell on ties
    has = mine.any(dim=-1)
    pix = torch.gather(loc_pix, 1, best)
    x = 8 * (best % wc) + pix % 8
    y = 8 * (best // wc) + pix // 8
    kpts = torch.stack([x, y], dim=-1).float() * has[..., None]
    return kpts, has


def decode(loc_hat: torch.Tensor, ids_hat: torch.Tensor, n_ids: int,
           min_margin: Optional[float] = None):
    """Launch the decode kernel on the current stream (CUDA tensors), or run
    :func:`decode_plain` (CPU tensors)."""
    global launches
    if not loc_hat.is_cuda:
        return decode_plain(loc_hat, ids_hat, n_ids, min_margin)
    n, hc, wc, cl = loc_hat.shape
    if cl != 65 or ids_hat.shape != (n, hc, wc, n_ids + 1) or not 0 < n_ids < 32:
        raise ValueError(f"decode: bad shapes loc {tuple(loc_hat.shape)}, "
                         f"ids {tuple(ids_hat.shape)}, n_ids {n_ids}")
    for t in (loc_hat, ids_hat):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != loc_hat.device:
            raise ValueError("decode: loc and ids must be contiguous float32 "
                             "NHWC tensors on one CUDA device")
    kpts = torch.empty((n, n_ids, 2), dtype=torch.float32, device=loc_hat.device)
    valid = torch.empty((n, n_ids), dtype=torch.bool, device=loc_hat.device)
    lib, fn = _fn()
    stream = torch.cuda.current_stream(loc_hat.device).cuda_stream
    status = fn(loc_hat.data_ptr(), ids_hat.data_ptr(), n, hc * wc, wc, n_ids,
                int(min_margin is not None),
                0.0 if min_margin is None else float(min_margin),
                kpts.data_ptr(), valid.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"decode kernel: {_build.error_string(lib, status)}")
    launches += 1
    return kpts, valid

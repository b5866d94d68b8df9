"""Corner decode kernel (``csrc/decode.cu``) and its plain version.

The CUDA counterpart of ``deepcharuco_tpu.ops.pallas_decode.
pallas_pred_to_keypoints``: loc logits (N, Hc, Wc, 65) and ids logits
(N, Hc, Wc, n_ids+1) → keypoints (N, n_ids, 2) float32 and valid
(N, n_ids) bool, with the optional ``min_margin`` gate of the fused kernel.
Invalid slots hold (0, 0).

:func:`decode` launches the kernel for CUDA tensors and runs
:func:`decode_plain` for CPU tensors; nothing else chooses between them.
Each launch adds one to the counter ``kernels.b1_launches``
(``profiling``).

Both kernels reduce the per-id winner across blocks through one 64-bit key
per claim (``csrc/decode_common.cuh``). :func:`winner_keys_plain` states
that key in plain PyTorch and :func:`keys_to_keypoints` inverts it; the
tests hold the two against :func:`decode_plain`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from deepcharuco_tpu_torch import _build, profiling

_P = ctypes.c_void_p
_I = ctypes.c_int

CELL_BITS = 24                    # bits of the cell index in the winner key
NO_CLAIM = -(1 << 63)             # the unsigned key 0, with its top bit flipped


@functools.lru_cache(maxsize=None)
def _fn():
    lib = _build.library("decode")
    fn = lib.dc_decode
    fn.argtypes = [_P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P, _P, _P, _P]
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


def check_cells(hc: int, wc: int) -> None:
    """Both kernels' winner key holds a cell index in CELL_BITS bits."""
    if hc * wc >= 1 << CELL_BITS:
        raise ValueError(f"{hc}×{wc} cells do not fit the winner key's "
                         f"{CELL_BITS}-bit cell index")


def winner_keys_plain(loc_hat: torch.Tensor, ids_hat: torch.Tensor, n_ids: int,
                      min_margin: Optional[float] = None) -> torch.Tensor:
    """The kernels' per-id winner keys, (N, n_ids) int64.

    A claim's key is ``ordered(conf) << 32 | (2**24 - 1 - cell) << 8 | pix``
    as an unsigned 64-bit number (``csrc/decode_common.cuh``), where
    ``ordered`` maps float bits monotonically to uint32 after −0.0 → +0.0.
    Here it is stored with its top bit flipped, so int64 order is the
    kernels' unsigned order; an id that no cell claims holds ``NO_CLAIM``.
    The winner is the largest key."""
    n, hc, wc, _ = loc_hat.shape
    loc = loc_hat.reshape(n, hc * wc, -1).float()
    ids = ids_hat.reshape(n, hc * wc, -1).float()
    pix = torch.argmax(loc, dim=-1)                         # (N, M), first max
    conf = ids.amax(dim=-1)
    ids_arg = torch.argmax(ids, dim=-1)
    claim = (pix != 64) & (ids_arg != n_ids)
    if min_margin is not None:
        claim &= (conf - ids[..., n_ids]) >= min_margin
    conf = torch.where(conf == 0, torch.zeros_like(conf), conf)   # −0.0 → +0.0
    u = conf.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ordered = torch.where(u >= 1 << 31, 0xFFFFFFFF - u, u | (1 << 31))
    cell = torch.arange(hc * wc, device=loc_hat.device)
    low = (((1 << CELL_BITS) - 1 - cell) << 8) | pix
    key = ((ordered - (1 << 31)) << 32) | low
    mine = claim[:, None, :] & (ids_arg[:, None, :] ==
                                torch.arange(n_ids, device=loc_hat.device)[None, :, None])
    return torch.where(mine, key[:, None, :],
                       torch.full_like(key[:, None, :], NO_CLAIM)).amax(dim=-1)


def keys_to_keypoints(keys: torch.Tensor, wc: int):
    """Winner keys (N, n_ids) int64 → keypoints (N, n_ids, 2) float32 and
    valid (N, n_ids) bool, (0, 0) where no cell claims: the kernels' last
    step."""
    valid = keys != NO_CLAIM
    low = keys & 0xFFFFFFFF
    cell = (1 << CELL_BITS) - 1 - (low >> 8)
    pix = low & 0xFF
    x = 8 * (cell % wc) + pix % 8
    y = 8 * (cell // wc) + pix // 8
    return torch.stack([x, y], dim=-1).float() * valid[..., None], valid


def decode(loc_hat: torch.Tensor, ids_hat: torch.Tensor, n_ids: int,
           min_margin: Optional[float] = None):
    """Launch the decode kernel on the current stream (CUDA tensors), or run
    :func:`decode_plain` (CPU tensors). Grids of 2**24 cells or more are
    refused on either device."""
    n, hc, wc, cl = loc_hat.shape
    if cl != 65 or ids_hat.shape != (n, hc, wc, n_ids + 1) or not 0 < n_ids < 32:
        raise ValueError(f"decode: bad shapes loc {tuple(loc_hat.shape)}, "
                         f"ids {tuple(ids_hat.shape)}, n_ids {n_ids}")
    check_cells(hc, wc)
    if not loc_hat.is_cuda:
        return decode_plain(loc_hat, ids_hat, n_ids, min_margin)
    for t in (loc_hat, ids_hat):
        if (t.dtype != torch.float32 or not t.is_contiguous() or t.device != loc_hat.device
                or t.data_ptr() % 16):
            raise ValueError("decode: loc and ids must be contiguous, 16-byte aligned "
                             "float32 NHWC tensors on one CUDA device")
    dev = loc_hat.device
    scratch = torch.zeros((n, n_ids + 1), dtype=torch.int64, device=dev)
    kpts = torch.empty((n, n_ids, 2), dtype=torch.float32, device=dev)
    valid = torch.empty((n, n_ids), dtype=torch.bool, device=dev)
    lib, fn = _fn()
    with torch.cuda.device(dev):
        status = fn(loc_hat.data_ptr(), ids_hat.data_ptr(), n, hc * wc, wc, n_ids,
                    int(min_margin is not None),
                    0.0 if min_margin is None else float(min_margin),
                    scratch.data_ptr(), kpts.data_ptr(), valid.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    if status != 0:
        raise RuntimeError(f"decode kernel: {_build.error_string(lib, status)}")
    profiling.count("kernels.b1_launches")
    return kpts, valid

"""Fused detector-head + decode kernel (``csrc/fused_head_decode.cu``), its
parameter fold and its plain version.

The CUDA counterpart of ``deepcharuco_tpu.ops.pallas_fused``: detector trunk
features (N, Hc, Wc, 128) → keypoints (N, n_ids, 2) float32 and valid
(N, n_ids) bool, the contract of ``pred_to_keypoints``. Invalid slots hold
(0, 0).

:func:`fused_head_decode` launches the kernel for CUDA tensors and runs
:func:`fused_head_decode_plain` for CPU tensors; nothing else chooses
between them. The kernel reads the weights in the layout of
:func:`pack_head_params` (``wh`` transposed to K-major, the 1×1 weights
transposed and padded), packed once on the host; :func:`unpack_head_weights`
is its inverse. :func:`head_params` gives both the fold and the packing, as
the wrapper takes them.
Each launch adds one to the counter ``kernels.b2_launches``
(``profiling``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch

from deepcharuco_tpu_torch import _build, profiling
from deepcharuco_tpu_torch.ops.cuda_decode import check_cells, decode_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
LOC_PAD, IDS_PAD = 72, 32   # 1×1 output widths the kernel's wgmma tiles take
PACKED = ("whT", "wpbT", "wdbT", "bias")


def fold_head_params(variables: Dict, n_ids: int = 16) -> Dict[str, torch.Tensor]:
    """Fold BatchNorm (inference affine) into the head conv weights, in numpy.

    ``variables`` is the JAX-layout tree of numpy arrays (``weights.
    variables_from_npz`` or ``weights.detector_variables``). Returns CPU
    tensors with the keys and shapes of the JAX package's fold:
    wpa/wda (9·128, 256) bf16 with 3×3 taps stacked row-major (ky·3+kx),
    bpa/bda (1, 256) f32, wh = [wpa | wda] (9·128, 512) bf16,
    wpb (256, 65) bf16, bpb (1, 65) f32, wdb (256, n_ids+1) bf16,
    bdb (1, n_ids+1) f32.
    """
    p = variables["params"]
    s = variables["batch_stats"]
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    bf16 = lambda a: f32(a).to(torch.bfloat16)

    def fold(name):
        k = np.asarray(p[name]["conv"]["kernel"], np.float32)   # (3,3,Cin,Cout)
        b = np.asarray(p[name]["conv"]["bias"], np.float32)
        gamma = np.asarray(p[name]["bn"]["scale"], np.float32)
        beta = np.asarray(p[name]["bn"]["bias"], np.float32)
        mean = np.asarray(s[name]["bn"]["mean"], np.float32)
        var = np.asarray(s[name]["bn"]["var"], np.float32)
        scale = gamma / np.sqrt(var + 1e-5)
        kf = k * scale
        bf = (b - mean) * scale + beta
        return bf16(kf.reshape(9 * k.shape[2], k.shape[3])), f32(bf[None, :])

    wpa, bpa = fold("convPa")
    wda, bda = fold("convDa")
    return dict(
        wpa=wpa, bpa=bpa, wda=wda, bda=bda, wh=torch.cat([wpa, wda], dim=1),
        wpb=bf16(np.asarray(p["convPb"]["kernel"])[0, 0]),
        bpb=f32(np.asarray(p["convPb"]["bias"])[None, :]),
        wdb=bf16(np.asarray(p["convDb"]["kernel"])[0, 0]),
        bdb=f32(np.asarray(p["convDb"]["bias"])[None, :]),
    )


def pack_head_params(folded: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``folded`` plus the layout the kernel reads, on the same device:

    - ``whT`` = wh.T (512, 9·128) bf16: each output channel's K row is
      contiguous, so a TMA box of it lands K-major, as ``wgmma`` reads B;
    - ``wpbT`` (72, 256) and ``wdbT`` (32, 256) bf16: the 1×1 weights
      transposed the same way, zero rows past 65 and n_ids+1;
    - ``bias`` (256 + 256 + 72 + 32) f32: bpa, bda, bpb, bdb, zero-padded.
    """
    def rows(w, n):
        t = w.t()
        return torch.cat([t, t.new_zeros(n - t.shape[0], t.shape[1])]).contiguous()

    def vec(b, n):
        b = b.reshape(-1).float()
        return torch.cat([b, b.new_zeros(n - b.numel())])

    return dict(folded, whT=folded["wh"].t().contiguous(),
                wpbT=rows(folded["wpb"], LOC_PAD), wdbT=rows(folded["wdb"], IDS_PAD),
                bias=torch.cat([vec(folded["bpa"], 256), vec(folded["bda"], 256),
                                vec(folded["bpb"], LOC_PAD), vec(folded["bdb"], IDS_PAD)]))


def head_params(variables: Dict, n_ids: int = 16, device="cpu") -> Dict[str, torch.Tensor]:
    """What :func:`fused_head_decode` takes, on ``device``: the fold of
    :func:`fold_head_params` (read by the plain version) and the layout of
    :func:`pack_head_params` (read by the kernel)."""
    return {k: v.to(device) for k, v in pack_head_params(
        fold_head_params(variables, n_ids)).items()}


def unpack_head_weights(packed: Dict[str, torch.Tensor], n_ids: int = 16):
    """Inverse of :func:`pack_head_params` for the weights and biases:
    {wh, wpb, wdb, bpa, bda, bpb, bdb} in ``fold_head_params``' shapes."""
    b = packed["bias"]
    return dict(wh=packed["whT"].t(), wpb=packed["wpbT"][:65].t(),
                wdb=packed["wdbT"][:n_ids + 1].t(), bpa=b[None, :256],
                bda=b[None, 256:512], bpb=b[None, 512:512 + 65],
                bdb=b[None, 512 + LOC_PAD:512 + LOC_PAD + n_ids + 1])


def fused_head_decode_plain(trunk: torch.Tensor, folded: Dict[str, torch.Tensor],
                            n_ids: int = 16, min_margin: Optional[float] = None):
    """The kernel's function in plain PyTorch (same contract, same device).

    bf16 × bf16 products are summed in float32: both operands are upcast
    before the matmul (a bf16 matmul would round its output), and the ReLU
    output is rounded to bf16 before the 1×1 convs, as in the kernel."""
    n, hc, wc, cin = trunk.shape
    x = trunk.to(torch.bfloat16).float()
    xpad = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    patch = torch.cat([xpad[:, ky:ky + hc, kx:kx + wc, :]
                       for ky in range(3) for kx in range(3)], dim=-1)
    pd = patch.reshape(n, hc * wc, 9 * cin) @ folded["wh"].float()
    half = pd.shape[-1] // 2
    p_act = torch.relu(pd[..., :half] + folded["bpa"]).to(torch.bfloat16).float()
    d_act = torch.relu(pd[..., half:] + folded["bda"]).to(torch.bfloat16).float()
    loc = p_act @ folded["wpb"].float() + folded["bpb"]
    ids = d_act @ folded["wdb"].float() + folded["bdb"]
    return decode_plain(loc.reshape(n, hc, wc, -1), ids.reshape(n, hc, wc, -1),
                        n_ids, min_margin)


@functools.lru_cache(maxsize=None)
def _fn():
    lib = _build.library("fused_head_decode")
    fn = lib.dc_fused_head_decode
    fn.argtypes = [_P] * 5 + [_I] * 6 + [ctypes.c_float, _P, _P, _P, _P]
    fn.restype = _I
    return lib, fn


def fused_head_decode(trunk: torch.Tensor, folded: Dict[str, torch.Tensor],
                      n_ids: int = 16, min_margin: Optional[float] = None):
    """Launch the fused kernel on the current stream (CUDA tensors), or run
    :func:`fused_head_decode_plain` (CPU tensors). ``folded`` is
    :func:`head_params` on the trunk's device: the kernel reads its
    :func:`pack_head_params` keys, the plain version the fold's. Grids of
    2**24 cells or more are refused on either device."""
    n, hc, wc, cin = trunk.shape
    check_cells(hc, wc)
    if not trunk.is_cuda:
        return fused_head_decode_plain(trunk, folded, n_ids, min_margin)
    dev = trunk.device
    if (trunk.dtype != torch.bfloat16 or not trunk.is_contiguous() or cin % 64
            or trunk.data_ptr() % 16):
        raise ValueError("fused_head_decode: trunk must be contiguous, 16-byte aligned "
                         "bf16 NHWC with channels a multiple of 64, got "
                         f"{trunk.dtype} {tuple(trunk.shape)}")
    if not 0 < n_ids < 32:
        raise ValueError(f"fused_head_decode: n_ids {n_ids} out of range")
    packed = {"whT": ((512, 9 * cin), torch.bfloat16),
              "wpbT": ((LOC_PAD, 256), torch.bfloat16),
              "wdbT": ((IDS_PAD, 256), torch.bfloat16),
              "bias": ((512 + LOC_PAD + IDS_PAD,), torch.float32)}
    for key, (shape, dtype) in packed.items():
        t = folded.get(key)
        if t is None:
            raise ValueError(f"fused_head_decode: folded[{key!r}] is missing; "
                             "pass head_params(...)")
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != dev
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"fused_head_decode: folded[{key!r}] must be a "
                             f"contiguous, 16-byte aligned {dtype} {shape} on {dev}")
    scratch = torch.zeros((n, n_ids + 1), dtype=torch.int64, device=dev)
    kpts = torch.empty((n, n_ids, 2), dtype=torch.float32, device=dev)
    valid = torch.empty((n, n_ids), dtype=torch.bool, device=dev)
    lib, fn = _fn()
    with torch.cuda.device(dev):
        status = fn(trunk.data_ptr(), *(folded[k].data_ptr() for k in PACKED),
                    n, hc, wc, cin, n_ids, int(min_margin is not None),
                    0.0 if min_margin is None else float(min_margin),
                    scratch.data_ptr(), kpts.data_ptr(), valid.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    if status != 0:
        raise RuntimeError(f"fused head kernel: {_build.error_string(lib, status)}")
    profiling.count("kernels.b2_launches")
    return kpts, valid

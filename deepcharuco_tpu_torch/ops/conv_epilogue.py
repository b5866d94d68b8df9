"""One pass after an inference convolution (``csrc/conv_epilogue.cu``) and
its plain version, with BatchNorm (:func:`epilogue`) or without it
(:func:`bias_relu`, a block with no norm, as SuperPoint's).

A ``ConvBNRelu`` block in eval runs its convolution without the bias, then
this epilogue: the conv bias, BatchNorm on the running statistics, ReLU and,
by ``then``, the 2×2 max-pool (floor) or the ×2 nearest upsample that
follows the block (``None``: the block's output as it is). Every rounding of
ATen's chain is kept: to bf16 after the bias add and after BatchNorm, with
ATen's own per-channel arithmetic in float32 (the kernel's source states
it). The function has no counterpart in the JAX package's kernels (XLA fuses
the chain into the convolution on the TPU).

:func:`epilogue` launches the kernel for CUDA tensors and runs
:func:`epilogue_plain` for CPU tensors; nothing else chooses between them.
Each launch adds one to the counter ``kernels.epilogue_launches``
(``profiling``); :func:`bias_relu` and :func:`bias_relu_plain` are the same
pair without BatchNorm: the bias add rounded to ``x.dtype``, ReLU, then.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from deepcharuco_tpu_torch import _build, profiling

_P = ctypes.c_void_p
_I = ctypes.c_int

THEN = {None: 0, "pool": 1, "up": 2}
MAX_CHANNELS = 2048               # C/8 threads of one block
MAX_VECTORS = 1 << 31             # 16-byte vectors of the input or output


@functools.lru_cache(maxsize=None)
def _fn():
    lib = _build.library("conv_epilogue")
    fn = lib.dc_conv_epilogue
    fn.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_float, _I, _I, _I, _I, _I, _P, _P]
    fn.restype = _I
    return lib, fn


@functools.lru_cache(maxsize=None)
def _fn_no_norm():
    lib = _build.library("conv_epilogue")
    fn = lib.dc_conv_bias_relu
    fn.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P, _P]
    fn.restype = _I
    return lib, fn


def _then(x, then):
    if then == "pool":
        h, w = x.shape[2] // 2 * 2, x.shape[3] // 2 * 2
        x = torch.maximum(torch.maximum(x[:, :, 0:h:2, 0:w:2], x[:, :, 0:h:2, 1:w:2]),
                          torch.maximum(x[:, :, 1:h:2, 0:w:2], x[:, :, 1:h:2, 1:w:2]))
    elif then == "up":
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return x.contiguous(memory_format=torch.channels_last)


def epilogue_plain(x: torch.Tensor, conv_bias: torch.Tensor, mean: torch.Tensor,
                   var: torch.Tensor, weight: torch.Tensor, shift: torch.Tensor,
                   eps: float, then=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (same contract, same device):
    ``x`` (N, C, H, W) is the convolution's output without its bias; the
    bias add rounds to ``x.dtype`` as the ``add_`` after cuDNN does, and
    BatchNorm is ATen's on the running statistics, rounded to ``x.dtype``.
    Returns channels_last (N, C, H//2, W//2) after a pool, (N, C, 2H, 2W)
    after an upsample, else (N, C, H, W)."""
    if then not in THEN:
        raise ValueError(f"conv epilogue: then must be one of {list(THEN)}, got {then!r}")
    x = x + conv_bias.view(1, -1, 1, 1)
    return _then(F.batch_norm(x, mean, var, weight, shift, False, 0.0, eps).clamp_min(0), then)


def bias_relu_plain(x: torch.Tensor, conv_bias: torch.Tensor, then=None) -> torch.Tensor:
    """:func:`bias_relu`'s function in plain PyTorch (same contract, same
    device): the bias add rounds to ``x.dtype``, then ReLU and ``then``."""
    if then not in THEN:
        raise ValueError(f"conv epilogue: then must be one of {list(THEN)}, got {then!r}")
    return _then((x + conv_bias.view(1, -1, 1, 1)).clamp_min(0), then)


def _check(x: torch.Tensor, conv_bias: torch.Tensor, then):
    """(mode, output) of a launch on ``x``, after the checks both entry
    points share."""
    mode = THEN.get(then, -1)
    n, c, h, w = x.shape
    dev = x.device
    if mode < 0:
        raise ValueError(f"conv epilogue: then must be one of {list(THEN)}, got {then!r}")
    if (x.dtype != torch.bfloat16 or not x.is_contiguous(memory_format=torch.channels_last)
            or x.data_ptr() % 16 or c % 8 or c > MAX_CHANNELS):
        raise ValueError("conv epilogue: x must be a 16-byte aligned bf16 channels_last "
                         f"tensor with C a multiple of 8 up to {MAX_CHANNELS}, got "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")
    if (conv_bias.dtype != torch.bfloat16 or conv_bias.device != dev
            or conv_bias.shape != (c,) or not conv_bias.is_contiguous()):
        raise ValueError(f"conv epilogue: the conv bias must be bf16 ({c},) on {dev}")
    ho, wo = (h // 2, w // 2) if then == "pool" else (2 * h, 2 * w) if then == "up" else (h, w)
    if max(h * w, ho * wo) * n * (c // 8) >= MAX_VECTORS:
        raise ValueError(f"conv epilogue: {tuple(x.shape)} holds 2^31 vectors or more")
    y = torch.empty((n, c, ho, wo), dtype=x.dtype, device=dev,
                    memory_format=torch.channels_last)
    return mode, y


def _launch(lib, fn, x: torch.Tensor, args) -> None:
    """``fn(*args, stream)`` on ``x``'s card; raises on a CUDA error."""
    dev = x.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    args = (*args, torch._C._cuda_getCurrentRawStream(idx))
    if idx == torch.cuda.current_device():
        status = fn(*args)
    else:
        with torch.cuda.device(idx):
            status = fn(*args)
    if status != 0:
        raise RuntimeError(f"conv epilogue kernel: {_build.error_string(lib, status)}")
    profiling.count("kernels.epilogue_launches")


def epilogue(x: torch.Tensor, conv_bias: torch.Tensor, mean: torch.Tensor,
             var: torch.Tensor, weight: torch.Tensor, shift: torch.Tensor,
             eps: float, then=None) -> torch.Tensor:
    """Launch the epilogue kernel on the current stream (CUDA tensors), or run
    :func:`epilogue_plain` (CPU tensors). On the card ``x`` is bf16
    channels_last with C a multiple of 8 up to 2048, ``conv_bias`` bf16 and
    the four BatchNorm tensors float32, all (C,) on ``x``'s device."""
    if not x.is_cuda:
        return epilogue_plain(x, conv_bias, mean, var, weight, shift, eps, then)
    n, c, h, w = x.shape
    for t in (mean, var, weight, shift):
        if (t.dtype != torch.float32 or t.device != x.device or t.shape != (c,)
                or not t.is_contiguous()):
            raise ValueError(f"conv epilogue: BatchNorm tensors must be float32 ({c},) "
                             f"on {x.device}")
    mode, y = _check(x, conv_bias, then)
    lib, fn = _fn()
    _launch(lib, fn, x, (x.data_ptr(), conv_bias.data_ptr(), mean.data_ptr(), var.data_ptr(),
                         weight.data_ptr(), shift.data_ptr(), eps, n, c, h, w, mode,
                         y.data_ptr()))
    return y


def bias_relu(x: torch.Tensor, conv_bias: torch.Tensor, then=None) -> torch.Tensor:
    """The epilogue kernel without BatchNorm on the current stream (CUDA
    tensors): the conv bias, ReLU, then ``then``; or :func:`bias_relu_plain`
    (CPU tensors). ``x`` and ``conv_bias`` as for :func:`epilogue`."""
    if not x.is_cuda:
        return bias_relu_plain(x, conv_bias, then)
    mode, y = _check(x, conv_bias, then)
    n, c, h, w = x.shape
    lib, fn = _fn_no_norm()
    _launch(lib, fn, x, (x.data_ptr(), conv_bias.data_ptr(), n, c, h, w, mode, y.data_ptr()))
    return y

"""Int8 post-training quantization of the detector
(``deepcharuco_tpu.models.quant``), inference only.

Scheme (no fine-tuning):

- **BatchNorm folding**: each ``conv → BN → ReLU`` block becomes
  ``conv' → ReLU`` with ``w' = w·γ/√(σ²+ε)`` and
  ``b' = (b−μ)·γ/√(σ²+ε) + β`` (running statistics).
- **Weights**: per-output-channel symmetric int8 over the folded kernel
  (``s_w[c] = max|w'[..,c]| / 127``).
- **Input**: the pipeline normalizes to ``(g−128)/255``, so a uint8 frame
  maps losslessly onto int8 with scale 1/255 and zero-point 0
  (``q = g−128``); int8 zero is the float path's padding zero, so the input
  conv pads with 0.
- **Inner activations**: per-tensor asymmetric int8 with zero-point −128.
  Every inner activation follows a ReLU, so ``q = round(y/s) − 128`` spends
  all 256 levels on ``[0, max]``. SAME padding inside pads with −128
  (activation 0), and the cross term ``zp·Σw`` is folded into the float bias
  when the weights are quantized.
- **Compute**: an int8 × int8 → int32 convolution, then a float32 epilogue
  ``acc·(s_x·s_w[c]) + b''[c] → ReLU → round(y/s_out) − 128 → clip``, each
  step its own float32 operation (no fused multiply-add: a value on a
  rounding boundary would flip). Max-pool commutes with the monotone
  quantizer and runs on int8.
- **Heads**: ``convPb``/``convDb`` (1×1, no BN/ReLU) dequantize straight to
  float32 logits, so the decode contract is unchanged.

**The integer convolution** has two routes, chosen by where the tensor
lies and by nothing else. On the CPU, ``F.conv2d`` on int32 copies of both
operands accumulates in int32. On a CUDA device there is no integer
convolution behind ``F.conv2d``; the route is an im2col of the padded int8
NHWC activations (nine shifted views concatenated on the channel axis,
which is the row order of the HWIO kernel reshaped to ``(9·I, O)``) and
``torch._int_mm``, the int8 tensor-core product with int32 accumulation.
Both are exact, so the accumulators agree bit for bit (``chip_smoke.py``
checks that on the card). The int32 accumulators and the im2col of a
full-resolution layer are several times the bf16 detector's activations, so
:class:`QuantDetector` walks a large batch in chunks of frames
(``_CHUNK_PIXELS``); frames do not interact, so the result is the same.

The artifact format is the JAX package's: a flat ``.npz`` of
``{layer}/{w,scale,bias,inv_s_out}`` with int8 HWIO kernels and a
``__quant__`` marker. :class:`QuantDetector` is an ``nn.Module`` with the
input and output contract of
:class:`~deepcharuco_tpu_torch.models.Detector`; its buffers are the
kernels, scales and biases.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepcharuco_tpu_torch._device import resolve_device
from deepcharuco_tpu_torch.models.detector import pool, to_nchw

# Encoder blocks in graph order; (name, pool_after).
_ENCODER = [
    ("conv1a", False), ("conv1b", True),
    ("conv2a", False), ("conv2b", True),
    ("conv3a", False), ("conv3b", True),
    ("conv4a", False), ("conv4b", False),
]
_HEADS = (("loc", "convPa", "convPb"), ("ids", "convDa", "convDb"))
_BN_EPS = 1e-5   # the detector's BatchNorm epsilon
_ZP = -128       # inner-activation zero-point
# input pixels that go through the net at once: 27 frames of 240×320, whose
# largest im2col (576 bytes per pixel) is 1.2 GB
_CHUNK_PIXELS = 1 << 21


def fold_bn(block_params: Dict[str, Any], block_stats: Dict[str, Any]):
    """Collapse a ConvBNRelu block's BN (running stats) into the conv:
    (kernel HWIO, bias) in float32 such that ``conv(x, kernel) + bias``
    equals ``BN(conv(x, w) + b)`` at inference."""
    f32 = lambda a: np.asarray(a, np.float32)
    s = f32(block_params["bn"]["scale"]) / np.sqrt(f32(block_stats["bn"]["var"])
                                                   + np.float32(_BN_EPS))
    kernel = f32(block_params["conv"]["kernel"]) * s          # HWIO: broadcasts over O
    bias = ((f32(block_params["conv"]["bias"]) - f32(block_stats["bn"]["mean"])) * s
            + f32(block_params["bn"]["bias"]))
    return kernel.astype(np.float32), bias.astype(np.float32)


def quantize_weight(kernel: np.ndarray):
    """Per-output-channel symmetric int8: (w_q int8, s_w (O,) float32)."""
    kernel = np.asarray(kernel, np.float32)
    absmax = np.abs(kernel).max(axis=(0, 1, 2))
    s_w = (np.maximum(absmax, np.float32(1e-12)) / np.float32(127.0)).astype(np.float32)
    w_q = np.clip(np.round(kernel / s_w), -127, 127).astype(np.int8)
    return w_q, s_w


@torch.inference_mode()
def calibrate_activations(detector, frames) -> Dict[str, float]:
    """Per-block output absmax over a calibration batch: ``frames`` are
    normalized float32 NHWC on the detector's device; returns {block: absmax}
    for every ConvBNRelu block (after its ReLU, so absmax = max, and before
    the pool that follows conv1b/conv2b/conv3b). Walks the trunk block by
    block, as the detector does."""
    out: Dict[str, float] = {}
    x = to_nchw(frames.to(detector.dtype))
    for name, pool_after in _ENCODER:
        x = getattr(detector, name)(x)
        out[name] = float(x.float().abs().max())
        if pool_after:
            x = pool(x)
    for _, block, _ in _HEADS:
        out[block] = float(getattr(detector, block)(x).float().abs().max())
    return out


def _fuse(w_q, s_w, bias, s_x: float, zp_x: int):
    """Fold the dequantization scale and the zero-point cross term into
    (scale, bias): with x = s_x·(q − zp_x) and padding value zp_x the
    accumulator satisfies conv(x, w) = s_x·s_w·(acc − zp_x·Σw_q), so
    y = acc·scale + bias_eff with scale = s_x·s_w and
    bias_eff = bias − zp_x·Σw_q·scale."""
    scale = (np.float32(s_x) * s_w).astype(np.float32)
    sum_w = w_q.astype(np.float32).sum(axis=(0, 1, 2))
    return scale, (bias - np.float32(zp_x) * sum_w * scale).astype(np.float32)


def quantize_detector(detector, det_vars, calib_frames, device=None) -> Dict[str, Any]:
    """The int8 parameter tree (numpy arrays, the artifact's layout) from
    float32 variables and calibration frames.

    ``detector`` is a float32 :class:`~deepcharuco_tpu_torch.models.Detector`
    holding ``det_vars`` (the JAX-layout tree of numpy arrays), on
    ``device`` (None → the card); ``calib_frames`` are normalized float32
    NHWC frames spanning the serving distribution (a few dozen synthesized
    boards suffice: the scales are max-based and the activations bounded by
    their ReLUs)."""
    dev = resolve_device(device)
    params, stats = det_vars["params"], det_vars["batch_stats"]
    act = calibrate_activations(detector.to(dev), torch.as_tensor(calib_frames).to(dev))

    q: Dict[str, Any] = {}
    s_in, zp_in = 1.0 / 255.0, 0   # exact input scale: q = g·255 = uint8 − 128
    for name in [n for n, _ in _ENCODER] + ["convPa", "convDa"]:
        kernel, bias = fold_bn(params[name], stats[name])
        w_q, s_w = quantize_weight(kernel)
        scale, bias_eff = _fuse(w_q, s_w, bias, s_in, zp_in)
        s_out = act[name] / 255.0  # 256 levels on [0, max], zp = −128
        q[name] = {"w": w_q, "scale": scale, "bias": bias_eff,
                   "inv_s_out": np.float32(1.0 / s_out)}
        if name == "conv4b":
            s_trunk = s_out        # both heads read conv4b's output
        s_in, zp_in = (s_out, _ZP) if name not in ("convPa", "convDa") else (s_trunk, _ZP)

    # head output convs (1×1, bias, no BN/ReLU) → float32 logits
    for name, src in (("convPb", "convPa"), ("convDb", "convDa")):
        w_q, s_w = quantize_weight(params[name]["kernel"])
        scale, bias_eff = _fuse(w_q, s_w, np.asarray(params[name]["bias"], np.float32),
                                1.0 / float(q[src]["inv_s_out"]), _ZP)
        q[name] = {"w": w_q, "scale": scale, "bias": bias_eff}
    return q


def _im2col(q_x: torch.Tensor, k: int, words: bool = True) -> torch.Tensor:
    """Padded int8 NHWC (n, h+k−1, w+k−1, c) → (n·h·w, k·k·c) rows in the
    order (dy, dx, channel) of an HWIO kernel reshaped to (k·k·I, O): the
    k·k shifted views concatenated on the channel axis. With ``words`` and
    c a multiple of 4 the copy moves four channels as one int32: the same
    bytes, a quarter of the elements (copying single bytes, the
    concatenation was the int8 detector's largest cost on an H100)."""
    n, hp, wp, c = q_x.shape
    h, w = hp - k + 1, wp - k + 1
    if k == 1:
        return q_x.reshape(n * h * w, c)
    words = words and c % 4 == 0
    src = q_x.contiguous().view(torch.int32) if words else q_x
    cols = torch.cat([src[:, dy:dy + h, dx:dx + w] for dy in range(k) for dx in range(k)],
                     dim=-1)
    if words:
        cols = cols.view(torch.int8)
    return cols.reshape(n * h * w, k * k * c)


def _int_mm_conv(q_x: torch.Tensor, w_oihw: torch.Tensor) -> torch.Tensor:
    """The card's route: im2col + ``torch._int_mm``, which wants more than
    16 rows and K and N in multiples of 8, so K (9 for the input layer) and
    N (65, 17 for the heads) are padded with zeros, and a tiny input with
    zero rows."""
    o, i, k, _ = w_oihw.shape
    n, hp, wp, _ = q_x.shape
    h, w = hp - k + 1, wp - k + 1
    kk = k * k * i
    k_pad, o_pad = -kk % 8, -o % 8
    # (O, k·k·I) rows in (dy, dx, channel) order; its transpose is the
    # column-major (K, N) operand that the int8 product reads
    w2d = F.pad(w_oihw.permute(0, 2, 3, 1).reshape(o, kk), (0, k_pad, 0, o_pad)).contiguous()
    cols = _im2col(q_x, k)
    rows = cols.shape[0]
    row_pad = max(0, 17 - rows)
    if k_pad or row_pad:        # F.pad copies even when it pads nothing
        cols = F.pad(cols, (0, k_pad, 0, row_pad))
    return torch._int_mm(cols, w2d.t())[:rows, :o].reshape(n, h, w, o)


def qconv_acc(q_x: torch.Tensor, w_oihw: torch.Tensor, pad: Optional[int]) -> torch.Tensor:
    """int8 NHWC activations ⊛ int8 OIHW kernel (3×3 SAME or 1×1) → int32
    NHWC accumulators. ``pad`` is the SAME-padding constant in the quantized
    domain: 0 for the input layer, −128 (activation 0) inside, None for a
    1×1 conv. A CPU tensor takes the int32 ``F.conv2d``, a CUDA tensor the
    im2col + ``torch._int_mm`` route."""
    if pad is not None and w_oihw.shape[-1] > 1:
        q_x = F.pad(q_x, (0, 0, 1, 1, 1, 1), value=pad)
    if q_x.is_cuda:
        return _int_mm_conv(q_x, w_oihw)
    acc = F.conv2d(q_x.permute(0, 3, 1, 2).to(torch.int32), w_oihw.to(torch.int32))
    return acc.permute(0, 2, 3, 1).contiguous()


def _requantize(acc: torch.Tensor, scale, bias, inv_s_out) -> torch.Tensor:
    """The block's float32 epilogue: dequantize + bias → ReLU → requantize.
    Every step is its own float32 operation, in this order. ``acc * scale``
    promotes the int32 accumulator to float32 inside the product, which is
    ``acc.float() * scale`` in one pass over the tensor; the rest runs in
    place on that result."""
    y = acc * scale
    y += bias
    y = torch.relu_(y)
    y *= inv_s_out
    return torch.round_(y).add_(_ZP).clamp_(-128, 127).to(torch.int8)


def _pool(q_x: torch.Tensor) -> torch.Tensor:
    """2×2 max-pool (floor) on int8 NHWC."""
    n, h, w, c = q_x.shape
    q_x = q_x[:, :h // 2 * 2, :w // 2 * 2]
    return q_x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class QuantDetector(nn.Module):
    """Drop-in :class:`~deepcharuco_tpu_torch.models.Detector` serving the
    int8 forward: (N, H, W, 1) normalized float32 in, ``{"loc", "ids"}``
    float32 NHWC logits out. ``qvars`` is the artifact's tree
    (:func:`qvars_from_npz`, :func:`quantize_detector`); the int8 kernels
    are kept OIHW."""

    def __init__(self, qvars: Dict[str, Any], n_ids: int = 16):
        super().__init__()
        self.n_ids = n_ids
        for name, layer in qvars.items():
            for key, value in layer.items():
                value = np.asarray(value)
                if key == "w":
                    value = np.ascontiguousarray(value.transpose(3, 2, 0, 1))
                self.register_buffer(f"{name}_{key}", torch.from_numpy(np.array(value)))

    def _layer(self, name: str):
        return tuple(getattr(self, f"{name}_{k}") for k in ("w", "scale", "bias"))

    def forward(self, x: torch.Tensor, trunk_only: bool = False,
                accumulators: Optional[List[torch.Tensor]] = None):
        """``accumulators``: a list that receives every layer's int32
        accumulator, in graph order (the ten blocks, then each head's 1×1
        conv after its block)."""
        if trunk_only:
            raise ValueError("QuantDetector has no bf16 trunk: the fused head + decode "
                             "kernel needs the float detector (fused_head=False here)")
        n, h, w = x.shape[:3]
        step = max(1, _CHUNK_PIXELS // max(1, h * w))
        if n <= step:
            return self._forward(x, accumulators)
        keep = accumulators is not None
        outs, accs = [], []
        for start in range(0, n, step):
            accs.append([] if keep else None)
            outs.append(self._forward(x[start:start + step], accs[-1]))
        if keep:
            accumulators.extend(torch.cat(layer) for layer in zip(*accs))
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def _forward(self, x: torch.Tensor, accumulators: Optional[List[torch.Tensor]]):
        keep = accumulators.append if accumulators is not None else (lambda acc: None)
        # x is (g−128)/255: for integer grays round(x·255) recovers g−128
        # exactly; fractional grays (a pooled hi-res view) add up to ±0.5
        # gray level of input quantization.
        q = torch.round(x.float() * 255.0).clamp(-128, 127).to(torch.int8)
        pad = 0     # input layer: int8 zero is the float path's padding zero
        for name, pool in _ENCODER:
            w, scale, bias = self._layer(name)
            acc = qconv_acc(q, w, pad)
            keep(acc)
            q = _requantize(acc, scale, bias, getattr(self, f"{name}_inv_s_out"))
            pad = _ZP
            if pool:
                q = _pool(q)
        heads = {}
        for out, a, b in _HEADS:
            w, scale, bias = self._layer(a)
            acc = qconv_acc(q, w, _ZP)
            keep(acc)
            h = _requantize(acc, scale, bias, getattr(self, f"{a}_inv_s_out"))
            w, scale, bias = self._layer(b)
            acc = qconv_acc(h, w, None)
            keep(acc)
            heads[out] = acc.float() * scale + bias
        return heads


def qvars_to_npz(path: str, qvars: Dict[str, Any]) -> None:
    """Flat ``.npz`` (int8 kernels stay int8 on disk) with the ``__quant__``
    marker that ``pipeline.is_quantized_npz`` routes by."""
    flat = {"__quant__": np.int8(1)}
    for name, layer in qvars.items():
        for k, v in layer.items():
            flat[f"{name}/{k}"] = np.asarray(v)
    np.savez(path, **flat)


def qvars_from_npz(path: str) -> Dict[str, Any]:
    """The artifact's tree of numpy arrays: {layer: {w, scale, bias[,
    inv_s_out]}}, kernels int8 HWIO."""
    q: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            if key == "__quant__":
                continue
            name, k = key.split("/", 1)
            q.setdefault(name, {})[k] = z[key]
    return q

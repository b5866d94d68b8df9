"""The inference pipeline: frames → corners → sub-pixel corners.

The port of ``deepcharuco_tpu.pipeline``'s main path: gray normalization,
:class:`~deepcharuco_tpu_torch.models.Detector`, the fixed-capacity decode,
the 24×24 patch gather, :class:`~deepcharuco_tpu_torch.models.RefineNet` and
the hard-argmax sub-pixel decode. On the card the decode is a CUDA kernel:
``fused_head=False`` runs the detector's heads and then the decode kernel
(``ops/cuda_decode.py``); ``fused_head=True`` stops the detector at its
trunk and runs heads + decode in one kernel (``ops/cuda_fused.py``).

- :func:`two_stage_forward` — tensors in, (keypoints, valid, refined) out
- :class:`InferencePipeline` — holds the models, numpy in and out
- :func:`load_pipeline` — builds one from ``.npz`` weight files

Every entry point takes ``device``: None means the card. Without a card it
raises unless the caller passes ``device="cpu"``, which runs the kernels'
plain versions.

Not ported yet (``NotImplementedError``, see ROADMAP.md "Open items"):
``decode_capacity > 1``, the geometry decode (``geom_*``), the hi-res tap,
the soft/offset/avg refinement decodes, PnP (``camera``) and the int8
detector.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from deepcharuco_tpu_torch._device import resolve_device
from deepcharuco_tpu_torch.configs import Config
from deepcharuco_tpu_torch.models import Detector, RefineNet
from deepcharuco_tpu_torch.ops import (extract_patches, normalize_gray,
                                       pred_to_keypoints, preprocess_bgr,
                                       refine_keypoints)
from deepcharuco_tpu_torch.ops.cuda_fused import fused_head_decode, head_params
from deepcharuco_tpu_torch.weights import (detector_state_dict, detector_variables,
                                           load_state,
                                           refinenet_state_dict, refinenet_variables,
                                           variables_from_npz)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, Open items {item})")


def _check_options(decode_capacity=1, rn_decode=None, soft_refine=False,
                   geom=False, hires=False, camera=None, det_quant=None):
    if decode_capacity != 1:
        _not_ported("decode_capacity > 1", "A7")
    if geom:
        _not_ported("the geometry decode (geom_*)", "A7")
    if hires:
        _not_ported("the hi-res patch tap", "A6")
    if soft_refine or rn_decode not in (None, "hard"):
        _not_ported(f"the {rn_decode or 'soft'!r} refinement decode", "A2")
    if camera is not None:
        _not_ported("PnP (camera, detect_with_pose, full_forward)", "A5")
    if det_quant is not None:
        _not_ported("the int8 detector", "A9")


def _to_gray_input(frames: torch.Tensor) -> torch.Tensor:
    """BGR uint8 (N,H,W,3), gray (N,H,W)/(N,H,W,1) in uint8 scale, or float
    gray already normalized to [-1, 1] → normalized NHWC float32.

    Float input is taken as already normalized: normalizing it again would
    collapse the image to ≈ −0.5 and detect nothing."""
    if frames.ndim == 4 and frames.shape[-1] == 3:
        return preprocess_bgr(frames)
    g = frames[..., 0] if frames.ndim == 4 else frames
    if frames.is_floating_point():
        return g.float()[..., None]
    return normalize_gray(g)


def _apply_refiner(refinenet: RefineNet, patches: torch.Tensor,
                   keypoints: torch.Tensor) -> torch.Tensor:
    """RefineNet on the gathered patches + the hard-argmax decode."""
    n, k, p, _ = patches.shape
    heat = refinenet(patches.reshape(n * k, p, p, 1)).reshape(n, k, 64, 64)
    return refine_keypoints(heat, keypoints)


@torch.inference_mode()
def two_stage_forward(detector: Detector, refinenet: Optional[RefineNet], frames,
                      n_ids: int, min_margin: Optional[float] = None,
                      soft_refine: bool = False, decode_capacity: int = 1,
                      rn_decode: Optional[str] = None, geom_board_xy=None,
                      geom_fill: bool = False, fused_head: bool = False,
                      folded: Optional[Dict[str, torch.Tensor]] = None,
                      device=None):
    """Detector → decode → patch gather → RefineNet → sub-pixel corners.

    ``frames`` (numpy or tensor) go to ``device``, where the models must
    already be. Returns (keypoints (N, n_ids, 2), valid (N, n_ids) bool,
    refined (N, n_ids, 2)) on that device; with no refinenet ``refined`` is
    the raw keypoints. ``fused_head=True`` decodes through the fused
    head + decode kernel with ``folded`` (``cuda_fused.head_params`` of the
    detector on the device; made here when None)."""
    _check_options(decode_capacity, rn_decode, soft_refine,
                   geom=geom_board_xy is not None or geom_fill)
    dev = resolve_device(device)
    frames = torch.as_tensor(frames).to(dev, non_blocking=True)
    g = _to_gray_input(frames)
    if fused_head:
        if folded is None:
            folded = head_params(detector_variables(detector.state_dict()), n_ids, dev)
        trunk = detector(g, trunk_only=True)["trunk"]
        keypoints, valid = fused_head_decode(trunk, folded, n_ids, min_margin)
    else:
        out = detector(g)
        keypoints, valid = pred_to_keypoints(out["loc"], out["ids"], n_ids,
                                             min_margin=min_margin)
    if refinenet is None:
        return keypoints, valid, keypoints
    patches = extract_patches(g, keypoints, patch_size=refinenet.patch_size)
    return keypoints, valid, _apply_refiner(refinenet, patches, keypoints)


def _is_quantized_npz(path: Optional[str]) -> bool:
    if not (path and str(path).endswith(".npz") and os.path.isfile(path)):
        return False
    with np.load(path) as z:
        return "__quant__" in z.files or (
            "conv1a/w" in z.files and z["conv1a/w"].dtype == np.int8)


def _load_variables(ckpt: Optional[str], kind: str, n_ids: int = 16):
    """JAX-layout variables from an ``.npz`` file, or seeded random ones."""
    if ckpt is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            if kind == "detector":
                return detector_variables(Detector(n_ids, torch.float32).state_dict())
            return refinenet_variables(RefineNet(torch.float32).state_dict())
    if not str(ckpt).endswith(".npz"):
        _not_ported("loading Lightning .ckpt files and orbax checkpoints", "A1")
    return variables_from_npz(ckpt)


def load_pipeline(config: Config, deepc_ckpt: Optional[str] = None,
                  refinenet_ckpt: Optional[str] = None, camera=None,
                  compute_dtype=torch.bfloat16, rn_upsample: str = "nearest",
                  rn_patch_size: int = 24, rn_decode: Optional[str] = None,
                  hires=False, geom_decode: bool = False, geom_fill: bool = False,
                  min_margin: Optional[float] = None, fused_head: bool = False,
                  device=None) -> "InferencePipeline":
    """An :class:`InferencePipeline` from ``.npz`` weight files (None → the
    detector gets seeded random weights, the refiner is left out)."""
    if _is_quantized_npz(deepc_ckpt):
        _not_ported("the int8 detector", "A9")
    dv = _load_variables(deepc_ckpt, "detector", config.n_ids)
    rv = (_load_variables(refinenet_ckpt, "refinenet")
          if refinenet_ckpt is not None else None)
    return InferencePipeline(config, dv, rv, camera=camera,
                             compute_dtype=compute_dtype, min_margin=min_margin,
                             rn_upsample=rn_upsample, rn_patch_size=rn_patch_size,
                             rn_decode=rn_decode, hires=hires,
                             geom_decode=geom_decode, geom_fill=geom_fill,
                             fused_head=fused_head, device=device)


class InferencePipeline:
    """Holds the models on the device; numpy in, numpy out.

    ``det_vars``/``rn_vars`` are the JAX-layout variable trees of numpy
    arrays that ``weights.variables_from_npz`` returns."""

    def __init__(self, config: Config, det_vars, rn_vars=None, camera=None,
                 compute_dtype=torch.bfloat16, min_margin: Optional[float] = None,
                 soft_refine: bool = False, rn_upsample: str = "nearest",
                 rn_patch_size: int = 24, decode_capacity: int = 1,
                 rn_decode: Optional[str] = None, hires=False,
                 geom_decode: bool = False, geom_fill: bool = False,
                 det_quant: Optional[str] = None, fused_head: bool = False,
                 device=None):
        _check_options(decode_capacity, rn_decode, soft_refine,
                       geom=geom_decode or geom_fill, hires=hires, camera=camera,
                       det_quant=det_quant)
        self.device = resolve_device(device)
        self.config = config
        self.n_ids = config.n_ids
        self.min_margin = min_margin
        self.fused_head = fused_head
        det = Detector(n_ids=config.n_ids, dtype=compute_dtype)
        self.detector = load_state(det, detector_state_dict(det_vars)).to(self.device).eval()
        self.refinenet = None
        if rn_vars is not None:
            rn = RefineNet(dtype=compute_dtype, upsample=rn_upsample,
                           patch_size=rn_patch_size)
            self.refinenet = load_state(rn, refinenet_state_dict(rn_vars)).to(self.device).eval()
        self.folded = (head_params(det_vars, config.n_ids, self.device)
                       if fused_head else None)

    def detect(self, frames: np.ndarray):
        """frames: (N,H,W,3) BGR uint8 / (N,H,W) gray →
        (keypoints, valid, refined) numpy arrays."""
        out = two_stage_forward(self.detector, self.refinenet, frames, self.n_ids,
                                min_margin=self.min_margin, fused_head=self.fused_head,
                                folded=self.folded, device=self.device)
        return tuple(t.cpu().numpy() for t in out)

    def keypoint_array(self, refined: np.ndarray, valid: np.ndarray):
        """One frame's keypoints + mask → (M, 3) float ``[x, y, id]`` rows
        sorted by id."""
        refined = np.asarray(refined)
        ids = np.nonzero(np.asarray(valid))[0]
        return np.concatenate([refined[ids], ids[:, None].astype(refined.dtype)],
                              axis=1)


__all__ = ["InferencePipeline", "load_pipeline", "two_stage_forward",
           "resolve_device"]

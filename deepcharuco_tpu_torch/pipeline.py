"""The inference pipeline: frames → corners → sub-pixel corners → pose.

The port of ``deepcharuco_tpu.pipeline``: gray normalization,
:class:`~deepcharuco_tpu_torch.models.Detector`, the fixed-capacity decode,
the patch gather, :class:`~deepcharuco_tpu_torch.models.RefineNet` with its
refinement decodes, and batched planar PnP, all on the device: uint8 frames
go in, small corner and pose arrays come out. On the card the decode is a
CUDA kernel: ``fused_head=False`` runs the detector's heads and then the
decode kernel (``ops/cuda_decode.py``); ``fused_head=True`` stops the
detector at its trunk and runs heads + decode in one kernel
(``ops/cuda_fused.py``).

- :func:`two_stage_forward` — frames → (keypoints, valid, refined)
- :func:`two_stage_forward_hires` — the same with the detector on a pooled
  view and RefineNet on full-resolution patches
- :func:`full_forward`, :func:`full_forward_hires` — + (ok, rvec, tvec,
  reproj_rms)
- :class:`Camera` — intrinsics in cv2 conventions
- :class:`InferencePipeline` — holds the models, numpy in and out
- :func:`load_pipeline` — builds one from weight files
- :func:`load_model_variables` — the weight tree of any weight form: a
  Lightning ``.ckpt`` (``compat``), a shipped ``.npz``, a directory of the
  port's ``train.checkpoints.CheckpointManager``, or seeded random weights
- :func:`load_detector_any`, :func:`is_quantized_npz` — the float detector
  or the int8 one (``models/quant.py``), by the file's layout

Every entry point takes ``device``: None means the card. Without a card it
raises unless the caller passes ``device="cpu"``, which runs the kernels'
plain versions.

The geometry decode (``geom_*``, ``ops/geom.py``) and the int8 detector
read the detector's logits, so both decode through the decode kernel and
refuse ``fused_head=True``. An orbax checkpoint directory of the JAX
trainers is JAX's format: :func:`load_model_variables` refuses it and names
the conversion.
"""

from __future__ import annotations

import dataclasses
import os
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from deepcharuco_tpu_torch._device import resolve_device
from deepcharuco_tpu_torch.board import inner_corner_object_points
from deepcharuco_tpu_torch.configs import Config
from deepcharuco_tpu_torch.models import Detector, RefineNet
from deepcharuco_tpu_torch.models.quant import QuantDetector, qvars_from_npz
from deepcharuco_tpu_torch.ops import (downsample2x, extract_patches,
                                       fill_from_homography, normalize_gray,
                                       pred_to_keypoints, pred_to_keypoints_geom,
                                       pred_to_keypoints_topk, preprocess_bgr,
                                       refine_keypoints, refine_keypoints_soft)
from deepcharuco_tpu_torch.ops.cuda_fused import fused_head_decode, head_params
from deepcharuco_tpu_torch.pnp import solve_pnp_batch
from deepcharuco_tpu_torch.weights import (detector_state_dict, detector_variables,
                                           load_state,
                                           refinenet_state_dict, refinenet_variables,
                                           variables_from_npz)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Intrinsics (cv2 conventions; dist = [k1, k2, p1, p2, k3, k4, k5, k6,
    s1, s2, s3, s4] — 4/5/8/12-coefficient vectors accepted, zero-padded)."""

    K: np.ndarray
    dist: np.ndarray

    @classmethod
    def from_npz(cls, path: str) -> "Camera":
        """Load a ``camera_params.npz`` (``camera_matrix``,
        ``distortion_coeffs``). cv2 emits 4, 5, 8, 12 or 14 coefficients;
        the projection model implements the rational + thin-prism model
        (the first 12), so those load exactly, and the 14-coefficient
        tilted-sensor model raises: truncating it would change the camera."""
        with np.load(path) as data:
            raw = np.asarray(data["distortion_coeffs"], np.float32).ravel()
            K = np.asarray(data["camera_matrix"], np.float32)
        if raw.size not in (0, 4, 5, 8, 12):
            raise ValueError(
                f"{raw.size}-coefficient distortion model unsupported "
                "(cv2 tilted-sensor τx/τy terms have no on-device "
                "implementation); re-calibrate without CALIB_TILTED_MODEL")
        dist = np.zeros(12, np.float32)
        dist[: raw.size] = raw
        return cls(K=K, dist=dist)

    def scaled(self, factor: float = 0.5) -> "Camera":
        """Intrinsics for a resampled view whose pixel grid maps as
        x' = (x + 0.5)·factor − 0.5 (area resampling with aligned pixel
        centers, ``ops.downsample2x``'s convention at factor 0.5): how the
        hi-res tap expresses a camera calibrated at the input resolution in
        pooled-view units. Distortion coefficients act on normalized
        coordinates and carry over unchanged."""
        K = np.array(self.K, np.float32, copy=True)
        K[0, 0] *= factor
        K[1, 1] *= factor
        K[0, 2] = (K[0, 2] + 0.5) * factor - 0.5
        K[1, 2] = (K[1, 2] + 0.5) * factor - 0.5
        return Camera(K=K, dist=self.dist)


# CUDA graphs of the pose tail that an InferencePipeline keeps, one per batch
# size (a server's last, shorter batch gets its own).
_MAX_POSE_GRAPHS = 8


# How far a RefineNet correction may move a homography-filled corner before
# the geometric prediction is trusted instead: a fill over occluded texture
# has no corner signal to refine, and the refiner drifts.
_FILL_TRUST_PX = 1.5


def _check_decode_options(detector, fused_head: bool, decode_capacity: int = 1,
                          geom: bool = False, geom_fill: bool = False,
                          geom_name: str = "geom_board_xy (geom decode)"):
    """The decode options that exclude each other, as ``ValueError``s."""
    if geom and decode_capacity > 1:
        raise ValueError("geom decode and decode_capacity>1 are exclusive")
    if geom_fill and not geom:
        raise ValueError(f"geom_fill requires {geom_name}")
    if not fused_head:
        return
    if decode_capacity > 1:
        raise ValueError("fused_head=True decodes one winner per id in the kernel; "
                         "decode_capacity > 1 needs fused_head=False")
    if geom:
        raise ValueError("fused_head=True keeps the logits inside the kernel; the geometry "
                         "decode reads them and its top-K candidates: it needs "
                         "fused_head=False")
    if isinstance(detector, QuantDetector):
        raise ValueError("fused_head=True reads a bf16 trunk and float heads; the int8 "
                         "detector decodes through the decode kernel: it needs "
                         "fused_head=False")


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
                   keypoints: torch.Tensor, mode: str = "hard") -> torch.Tensor:
    """RefineNet on the gathered patches + the decode ``mode`` selects
    (``two_stage_forward``'s ``rn_decode``). ``keypoints`` are the integer
    patch centers in the pixel units of the patches' frame; so is the
    result."""
    n, k, p, _ = patches.shape
    out = refinenet(patches.reshape(n * k, p, p, 1))
    if isinstance(out, dict):
        heat, offset = out["heat"], out["offset"].reshape(n, k, 2)
    else:
        heat, offset = out, None
    heat = heat.reshape(n, k, 64, 64)
    if mode in ("offset", "avg") and offset is None:
        raise ValueError(
            f"rn_decode={mode!r} needs RefineNet(offset_head=True) and an "
            "offset-trained checkpoint")
    if mode == "offset":
        return keypoints + offset
    if mode == "avg":
        return 0.5 * (refine_keypoints_soft(heat, keypoints) + keypoints + offset)
    if mode == "soft":
        return refine_keypoints_soft(heat, keypoints)
    return refine_keypoints(heat, keypoints)


def _decode(detector, g: torch.Tensor, n_ids: int, min_margin,
            fused_head: bool, folded):
    """Detector + one-slot decode on normalized gray frames."""
    if fused_head:
        if folded is None:
            folded = head_params(detector_variables(detector.state_dict()), n_ids,
                                 g.device)
        trunk = detector(g, trunk_only=True)["trunk"]
        return fused_head_decode(trunk, folded, n_ids, min_margin)
    out = detector(g)
    return pred_to_keypoints(out["loc"], out["ids"], n_ids, min_margin=min_margin)


def _decode_geom(detector, g: torch.Tensor, n_ids: int, min_margin, board_xy,
                 fill: bool, ransac: int, noise):
    """Detector + geometry decode (+ fill) on normalized gray frames →
    (keypoints, valid, filled). The fills are reckoned in the units of
    ``g``'s pixel grid."""
    dev = g.device
    board_xy = torch.as_tensor(board_xy, dtype=torch.float32).to(dev)
    if noise is not None:
        noise = tuple(torch.as_tensor(t, dtype=torch.float32).to(dev) for t in noise)
    out = detector(g)
    keypoints, valid = pred_to_keypoints_geom(out["loc"], out["ids"], n_ids, board_xy,
                                              min_margin=min_margin,
                                              ransac_subsets=ransac, noise=noise)
    if not fill:
        return keypoints, valid, torch.zeros_like(valid)
    return fill_from_homography(keypoints, valid, board_xy, tuple(g.shape[1:3]))


def _trust_fills(refined: torch.Tensor, keypoints: torch.Tensor,
                 filled: torch.Tensor) -> torch.Tensor:
    """For a visible undetected corner the refinement sharpens the fill; for
    an occluded one the patch carries no corner signal and the refiner
    drifts, which would poison the pose. The refinement of a filled id is
    kept only while it stays within ``_FILL_TRUST_PX`` of the geometric
    prediction."""
    drift = torch.linalg.vector_norm(refined - keypoints, dim=-1, keepdim=True)
    keep = filled[..., None] & (drift > _FILL_TRUST_PX)
    return torch.where(keep, keypoints.to(refined.dtype), refined)


@torch.inference_mode()
def two_stage_forward(detector, refinenet: Optional[RefineNet], frames,
                      n_ids: int, min_margin: Optional[float] = None,
                      soft_refine: bool = False, decode_capacity: int = 1,
                      rn_decode: Optional[str] = None, geom_board_xy=None,
                      geom_fill: bool = False, geom_ransac: int = 32,
                      return_filled: bool = False, geom_noise=None,
                      fused_head: bool = False,
                      folded: Optional[Dict[str, torch.Tensor]] = None,
                      device=None):
    """Detector → decode → patch gather → RefineNet → sub-pixel corners.

    ``frames`` (numpy or tensor) go to ``device``, where the models must
    already be. Returns (keypoints (N, n_ids, 2), valid (N, n_ids) bool,
    refined (N, n_ids, 2)) on that device; with no refinenet ``refined`` is
    the raw keypoints. ``detector`` is a
    :class:`~deepcharuco_tpu_torch.models.Detector` or the int8
    :class:`~deepcharuco_tpu_torch.models.quant.QuantDetector`.
    ``fused_head=True`` decodes through the fused head + decode kernel with
    ``folded`` (``cuda_fused.head_params`` of the detector on the device;
    made here when None).

    ``rn_decode`` selects the refinement decode: ``"hard"`` (argmax, the
    default), ``"soft"`` (soft-argmax; ``soft_refine=True`` is the same),
    ``"offset"`` (the offset-regression branch) or ``"avg"`` (the mean of
    the soft-argmax and offset estimates); the last two need a
    ``RefineNet(offset_head=True)``.

    ``decode_capacity > 1`` switches to the duplicate-preserving decode
    (``ops.pred_to_keypoints_topk``): K slots per id, every decoded cell
    refined. Shapes become (N, n_ids, K, 2) / (N, n_ids, K) /
    (N, n_ids, K, 2); slot [:, :, 0] is the default decode's winner. The
    fused kernel keeps one winner per id, so it cannot serve this decode.

    ``geom_board_xy`` (the board's inner-corner plane coordinates,
    (n_ids, 2)) switches to the geometry-consistent decode
    (``ops.pred_to_keypoints_geom``) with ``geom_ransac`` seed subsets and
    the Gumbel tables ``geom_noise`` (None → ``ops.geom.default_noise``);
    exclusive with ``decode_capacity > 1`` and with ``fused_head``.
    ``geom_fill`` (needs ``geom_board_xy``) also predicts every undetected
    in-frame id at its homography-projected position
    (``ops.fill_from_homography``) and refines it in the same RefineNet
    pass. ``return_filled=True`` appends the ``filled`` mask (N, n_ids) to
    the result (all False without ``geom_fill``)."""
    geom = geom_board_xy is not None
    _check_decode_options(detector, fused_head, decode_capacity, geom, geom_fill)
    dev = resolve_device(device)
    g = _to_gray_input(torch.as_tensor(frames).to(dev, non_blocking=True))
    filled = None
    if decode_capacity > 1:
        out = detector(g)
        kp_k, valid = pred_to_keypoints_topk(out["loc"], out["ids"], n_ids,
                                             capacity=decode_capacity,
                                             min_margin=min_margin)
        keypoints = kp_k.reshape(kp_k.shape[0], n_ids * decode_capacity, 2)
    elif geom:
        keypoints, valid, filled = _decode_geom(detector, g, n_ids, min_margin,
                                                geom_board_xy, geom_fill, geom_ransac,
                                                geom_noise)
    else:
        keypoints, valid = _decode(detector, g, n_ids, min_margin, fused_head, folded)
    if filled is None:
        filled = torch.zeros_like(valid)
    out_shape = valid.shape + (2,)
    if refinenet is None:
        refined = keypoints = keypoints.reshape(out_shape)
    else:
        patches = extract_patches(g, keypoints, patch_size=refinenet.patch_size)
        mode = rn_decode or ("soft" if soft_refine else "hard")
        refined = _apply_refiner(refinenet, patches, keypoints, mode)
        if geom_fill:
            refined = _trust_fills(refined, keypoints, filled)
        keypoints, refined = keypoints.reshape(out_shape), refined.reshape(out_shape)
    return (keypoints, valid, refined, filled) if return_filled else \
        (keypoints, valid, refined)


@torch.inference_mode()
def two_stage_forward_hires(detector, refinenet: RefineNet, frames_hi,
                            n_ids: int, min_margin: Optional[float] = None,
                            rn_decode: str = "soft", geom_board_xy=None,
                            geom_fill: bool = False, geom_ransac: int = 32,
                            return_filled: bool = False, geom_noise=None,
                            scale: int = 2, fused_head: bool = False,
                            folded: Optional[Dict[str, torch.Tensor]] = None,
                            device=None):
    """Hi-res patch tap: the detector on a ``scale``×-downsampled view,
    RefineNet on full-resolution patches.

    ``frames_hi`` are (N, s·H, s·W[, C]), e.g. the camera's native 640×480
    when the detector runs its 320×240 grid (``scale=2``). The detector's
    cost is unchanged (it sees the pooled view) and the refiner sees
    ``scale``× the detail in patches of the same size.

    Coordinate contract: each 2×2 average pool puts low-res center x at
    hi-res coordinate 2x + 0.5 (``ops.downsample2x``); composed
    log2(scale) times that is x_hi = s·x_lo + (s−1)/2, so refined hi-res
    positions map back as (x_hi − (s−1)/2)/s. Returns (keypoints, valid,
    refined) in LOW-res pixel units, comparable with
    :func:`two_stage_forward`'s. The geometry options are
    :func:`two_stage_forward`'s; the fills and their trust guard live in
    pooled-view (low-res) units."""
    if scale not in (2, 4):
        raise ValueError(f"hires tap supports scale 2 or 4, got {scale}")
    geom = geom_board_xy is not None
    _check_decode_options(detector, fused_head, 1, geom, geom_fill)
    dev = resolve_device(device)
    g_hi = _to_gray_input(torch.as_tensor(frames_hi).to(dev, non_blocking=True))
    g_lo = g_hi
    for _ in range(scale.bit_length() - 1):
        g_lo = downsample2x(g_lo)
    if geom:
        keypoints, valid, filled = _decode_geom(detector, g_lo, n_ids, min_margin,
                                                geom_board_xy, geom_fill, geom_ransac,
                                                geom_noise)
    else:
        keypoints, valid = _decode(detector, g_lo, n_ids, min_margin, fused_head, folded)
        filled = torch.zeros_like(valid)
    kp_hi = float(scale) * keypoints            # integer patch centers, hi-res frame
    patches = extract_patches(g_hi, kp_hi, patch_size=refinenet.patch_size)
    refined_hi = _apply_refiner(refinenet, patches, kp_hi, rn_decode)
    refined = (refined_hi - (scale - 1) * 0.5) / scale
    if geom_fill:
        refined = _trust_fills(refined, keypoints, filled)
    return (keypoints, valid, refined, filled) if return_filled else \
        (keypoints, valid, refined)


def _solve(object_points, refined, valid, K, dist, pnp_iters):
    dev = refined.device
    as_f32 = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)
    return solve_pnp_batch(as_f32(object_points), refined.float(), valid,
                           as_f32(K), as_f32(dist), iters=pnp_iters)


@torch.inference_mode()
def full_forward(detector, refinenet: Optional[RefineNet], frames,
                 n_ids: int, object_points, K, dist, pnp_iters: int = 20,
                 soft_refine: bool = False, min_margin: Optional[float] = None,
                 rn_decode: Optional[str] = None, geom_board_xy=None,
                 geom_fill: bool = False, geom_ransac: int = 32, geom_noise=None,
                 fused_head: bool = False,
                 folded: Optional[Dict[str, torch.Tensor]] = None, device=None):
    """:func:`two_stage_forward` + batched planar PnP. Returns (keypoints,
    valid, refined, ok (N,), rvec (N, 3), tvec (N, 3), reproj_rms (N,)).

    With ``geom_fill`` the pose is solved from the measured detections only:
    filled corners lie on the fitted homography by construction, add no
    independent evidence, and their correlated extrapolation error would
    bias the pose. The returned corner set still holds the fills."""
    keypoints, valid, refined, filled = two_stage_forward(
        detector, refinenet, frames, n_ids, min_margin=min_margin,
        soft_refine=soft_refine, rn_decode=rn_decode, geom_board_xy=geom_board_xy,
        geom_fill=geom_fill, geom_ransac=geom_ransac, return_filled=True,
        geom_noise=geom_noise, fused_head=fused_head, folded=folded, device=device)
    return (keypoints, valid, refined,
            *_solve(object_points, refined, valid & ~filled, K, dist, pnp_iters))


@torch.inference_mode()
def full_forward_hires(detector, refinenet: RefineNet, frames_hi,
                       n_ids: int, object_points, K, dist, pnp_iters: int = 20,
                       min_margin: Optional[float] = None, rn_decode: str = "soft",
                       geom_board_xy=None, geom_fill: bool = False,
                       geom_ransac: int = 32, geom_noise=None, scale: int = 2,
                       fused_head: bool = False,
                       folded: Optional[Dict[str, torch.Tensor]] = None, device=None):
    """:func:`two_stage_forward_hires` + batched planar PnP (from the
    measured detections only, as :func:`full_forward`).

    ``K``/``dist`` must be in the LOW-res (pooled-view) pixel units the tap
    reports corners in: convert a camera calibrated at the hi-res input
    resolution with ``Camera.scaled(1/scale)``."""
    keypoints, valid, refined, filled = two_stage_forward_hires(
        detector, refinenet, frames_hi, n_ids, min_margin=min_margin,
        rn_decode=rn_decode, geom_board_xy=geom_board_xy, geom_fill=geom_fill,
        geom_ransac=geom_ransac, return_filled=True, geom_noise=geom_noise,
        scale=scale, fused_head=fused_head, folded=folded, device=device)
    return (keypoints, valid, refined,
            *_solve(object_points, refined, valid & ~filled, K, dist, pnp_iters))


def is_quantized_npz(ckpt: Optional[str]) -> bool:
    """True if ``ckpt`` is an int8 detector artifact (the layout
    ``models.quant.qvars_to_npz`` writes): the ``__quant__`` marker key, or,
    for artifacts written before the marker, a flat ``conv1a/w`` kernel that
    is int8. A missing or corrupt file gives False, so that the float loader
    raises its own, clearer error."""
    if not (ckpt and str(ckpt).endswith(".npz") and os.path.isfile(ckpt)):
        return False
    try:
        with np.load(ckpt) as z:
            if "__quant__" in z.files:
                return True
            return "conv1a/w" in z.files and z["conv1a/w"].dtype == np.int8
    except (OSError, ValueError, zipfile.BadZipFile):
        return False


def merge_variables(dst, src, _path=""):
    """Overlay ``src`` leaves onto ``dst`` where the tree path exists and the
    shape matches; leaves unique to either side stay as in ``dst``. Returns
    (merged, loaded_paths, skipped_paths): how a superset network (the 32-px
    RefineNet, the offset branch) warm-starts from a subset's weights."""
    loaded, skipped = [], []
    if isinstance(dst, dict) and isinstance(src, dict):
        merged = {}
        for k, v in dst.items():
            if k in src:
                m, lo, sk = merge_variables(v, src[k], f"{_path}/{k}")
                merged[k] = m
                loaded += lo
                skipped += sk
            else:
                merged[k] = v
                skipped.append(f"{_path}/{k} (absent in source)")
        for k in src:
            if k not in dst:
                skipped.append(f"{_path}/{k} (absent in target)")
        return merged, loaded, skipped
    if getattr(dst, "shape", None) == getattr(src, "shape", ()):
        return src, [_path], []
    return dst, [], [f"{_path} (shape {getattr(src, 'shape', '?')} vs "
                     f"{getattr(dst, 'shape', '?')})"]


def load_model_variables(ckpt: Optional[str], kind: str, n_ids: int = 16):
    """The JAX-layout weight tree (numpy) of ``kind`` (``"detector"`` or
    ``"refinenet"``) from any weight form the JAX package's
    ``load_model_variables`` takes that is not JAX's own:

    - ``*.ckpt``: a reference Lightning checkpoint, through ``compat``;
    - ``*.npz``: the shipped format;
    - a directory holding ``variables.npz``: a checkpoint of the port's
      ``train.checkpoints.CheckpointManager`` (``<ckpt-dir>/step_NNNNNNN``);
    - ``None``: seeded random weights (``torch.manual_seed(0)``).

    A directory without ``variables.npz`` (an orbax checkpoint of the JAX
    trainers) raises ``ValueError``: convert it where JAX is installed, with
    the JAX package's ``load_model_variables`` then ``variables_to_npz``."""
    if kind not in ("detector", "refinenet"):
        raise ValueError(f"kind must be 'detector' or 'refinenet', got {kind!r}")
    if ckpt is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            if kind == "detector":
                return detector_variables(Detector(n_ids, torch.float32).state_dict())
            return refinenet_variables(RefineNet(torch.float32).state_dict())
    ckpt = str(ckpt)
    if ckpt.endswith(".ckpt"):
        from deepcharuco_tpu_torch.compat import (detector_variables_from_torch,
                                                  load_lightning_checkpoint,
                                                  refinenet_variables_from_torch)

        convert = (detector_variables_from_torch if kind == "detector"
                   else refinenet_variables_from_torch)
        return convert(load_lightning_checkpoint(ckpt))
    if ckpt.endswith(".npz"):
        return variables_from_npz(ckpt)
    if os.path.isdir(ckpt):
        from deepcharuco_tpu_torch.train.checkpoints import VARIABLES

        path = os.path.join(ckpt, VARIABLES)
        if os.path.isfile(path):
            return variables_from_npz(path)
        raise ValueError(
            f"{ckpt} holds no {VARIABLES}: an orbax checkpoint of the JAX trainers is "
            "JAX's format. Convert it where JAX is installed: "
            "deepcharuco_tpu.pipeline.load_model_variables(dir, kind), then "
            "deepcharuco_tpu.pipeline.variables_to_npz(out.npz, variables)")
    raise ValueError(f"{ckpt}: not a .ckpt or .npz file or a checkpoint directory")


def load_detector_any(ckpt: Optional[str], n_ids: int,
                      compute_dtype=torch.bfloat16, device=None):
    """The detector for any detector weight file, in eval mode on ``device``
    (None → the card): a :class:`~deepcharuco_tpu_torch.models.Detector` in
    ``compute_dtype`` for float weights (None → seeded random ones), or the
    int8 :class:`~deepcharuco_tpu_torch.models.quant.QuantDetector` when
    ``ckpt`` is a quantized artifact (:func:`is_quantized_npz`)."""
    dev = resolve_device(device)
    if is_quantized_npz(ckpt):
        return QuantDetector(qvars_from_npz(ckpt), n_ids).to(dev).eval()
    det = Detector(n_ids=n_ids, dtype=compute_dtype)
    sd = detector_state_dict(load_model_variables(ckpt, "detector", n_ids))
    return load_state(det, sd).to(dev).eval()


def load_pipeline(config: Config, deepc_ckpt: Optional[str] = None,
                  refinenet_ckpt: Optional[str] = None,
                  camera: Optional[Camera] = None,
                  compute_dtype=torch.bfloat16, rn_upsample: str = "nearest",
                  rn_patch_size: int = 24, rn_decode: Optional[str] = None,
                  hires=False, geom_decode: bool = False, geom_fill: bool = False,
                  geom_ransac: int = 32, geom_noise=None,
                  min_margin: Optional[float] = None, pnp_iters: int = 20,
                  soft_refine: bool = False, decode_capacity: int = 1,
                  fused_head: bool = False, device=None) -> "InferencePipeline":
    """An :class:`InferencePipeline` from weight files in any form
    :func:`load_model_variables` takes (None → the detector gets seeded
    random weights, the refiner is left out).
    ``hires``: False (base resolution), True/2 (2× patch tap), or 4. An int8
    detector artifact is recognised by its layout and served through
    :class:`~deepcharuco_tpu_torch.models.quant.QuantDetector`; no flag."""
    det_quant = "int8" if is_quantized_npz(deepc_ckpt) else None
    dv = (qvars_from_npz(deepc_ckpt) if det_quant
          else load_model_variables(deepc_ckpt, "detector", config.n_ids))
    rv = (load_model_variables(refinenet_ckpt, "refinenet")
          if refinenet_ckpt is not None else None)
    return InferencePipeline(config, dv, rv, camera=camera, det_quant=det_quant,
                             compute_dtype=compute_dtype, pnp_iters=pnp_iters,
                             soft_refine=soft_refine, min_margin=min_margin,
                             rn_upsample=rn_upsample, rn_patch_size=rn_patch_size,
                             decode_capacity=decode_capacity,
                             rn_decode=rn_decode, hires=hires,
                             geom_decode=geom_decode, geom_fill=geom_fill,
                             geom_ransac=geom_ransac, geom_noise=geom_noise,
                             fused_head=fused_head, device=device)


class InferencePipeline:
    """Holds the models on the device; numpy in, numpy out.

    ``det_vars``/``rn_vars`` are the JAX-layout variable trees of numpy
    arrays that ``weights.variables_from_npz`` returns.

    ``hires`` (True/2, or 4) turns on the hi-res patch tap:
    :meth:`detect`/:meth:`detect_with_pose` then take frames at ``hires``×
    the detector's resolution and report in LOW-res units; the camera, if
    given, is the one calibrated at the INPUT resolution and is rescaled
    here (:meth:`Camera.scaled`). The tap decodes ``"soft"`` unless
    ``rn_decode`` says otherwise.

    ``decode_capacity > 1`` gives :meth:`detect` K slots per id. The pose
    path is per id by construction (object points are indexed by id), so
    :meth:`detect_with_pose` always runs the one-slot decode.

    ``geom_decode`` reselects each id's candidate by planar-homography
    consistency with the board (``ops/geom.py``; ``geom_ransac`` seed
    subsets, ``geom_noise`` its Gumbel tables or None for the seeded
    default), ``geom_fill`` adds the homography-predicted undetected ids;
    the pose is solved from the measured detections only.
    ``det_quant="int8"`` takes ``det_vars`` as the int8 tree of
    ``models.quant`` and serves it through ``QuantDetector``. Both decode
    from the logits: with ``fused_head=True`` they raise ``ValueError``."""

    def __init__(self, config: Config, det_vars, rn_vars=None,
                 camera: Optional[Camera] = None,
                 compute_dtype=torch.bfloat16, pnp_iters: int = 20,
                 soft_refine: bool = False, min_margin: Optional[float] = None,
                 rn_upsample: str = "nearest", rn_patch_size: int = 24,
                 decode_capacity: int = 1, rn_decode: Optional[str] = None,
                 hires=False, geom_decode: bool = False, geom_fill: bool = False,
                 geom_ransac: int = 32, geom_noise=None,
                 det_quant: Optional[str] = None, fused_head: bool = False,
                 device=None):
        if det_quant not in (None, "int8"):
            raise ValueError(f"unknown det_quant {det_quant!r}")
        self.device = resolve_device(device)
        if det_quant == "int8":
            detector = QuantDetector(det_vars, config.n_ids)
        else:
            detector = load_state(Detector(n_ids=config.n_ids, dtype=compute_dtype),
                                  detector_state_dict(det_vars))
        _check_decode_options(detector, fused_head, decode_capacity, geom_decode,
                              geom_fill, geom_name="geom_decode=True")
        self.hires_scale = (2 if hires is True else int(hires)) if hires else 1
        self.hires = bool(hires)
        if hires:
            if self.hires_scale not in (2, 4):
                raise ValueError(f"hires accepts True/2/4, got {hires!r}")
            if rn_vars is None:
                raise ValueError("hires tap needs RefineNet weights "
                                 "(the full-res patches ARE the point)")
            if decode_capacity > 1:
                raise ValueError("hires does not support decode_capacity > 1")
        self.config = config
        self.n_ids = config.n_ids
        self.min_margin = min_margin
        self.fused_head = fused_head
        self.pnp_iters = pnp_iters
        self.decode_capacity = decode_capacity
        self.rn_decode = (rn_decode or "soft") if hires else \
            rn_decode or ("soft" if soft_refine else "hard")
        self.detector = detector.to(self.device).eval()
        self.refinenet = None
        if rn_vars is not None:
            self.refinenet = self._refinenet(rn_vars, compute_dtype, rn_upsample,
                                             rn_patch_size).to(self.device).eval()
        self.folded = (head_params(det_vars, config.n_ids, self.device)
                       if fused_head else None)
        self.camera = camera
        as_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(self.device)
        self.object_points = as_dev(inner_corner_object_points(
            config.row_count, config.col_count, config.square_len))
        self._geom = dict(
            geom_board_xy=self.object_points[:, :2] if geom_decode else None,
            geom_fill=geom_fill, geom_ransac=geom_ransac,
            geom_noise=None if geom_noise is None else tuple(as_dev(t) for t in geom_noise))
        self._pose_graphs: Dict[int, tuple] = {}
        if camera is not None:
            cam = camera.scaled(1.0 / self.hires_scale) if hires else camera
            self._K, self._dist = as_dev(cam.K), as_dev(cam.dist)

    def _refinenet(self, rn_vars, dtype, upsample, patch_size) -> RefineNet:
        """The RefineNet variant the options ask for, with ``rn_vars``; a
        ``ValueError`` names what the weights lack."""
        needs_offset = self.rn_decode in ("offset", "avg")
        params = rn_vars["params"]
        if needs_offset and "denseOa" not in params:
            raise ValueError(
                f"rn_decode={self.rn_decode!r} needs RefineNet(offset_head=True) "
                "and an offset-trained checkpoint")
        if (patch_size == 32) != ("conv2c" in params):
            raise ValueError(
                f"rn_patch_size={patch_size} does not fit these RefineNet weights "
                f"({'with' if 'conv2c' in params else 'without'} conv2c/conv2d, "
                "the 32-px front end)")
        rn = RefineNet(dtype=dtype, upsample=upsample, patch_size=patch_size,
                       offset_head=needs_offset)
        sd = refinenet_state_dict(rn_vars)
        if not needs_offset:    # an offset branch in the weights stays unused
            sd = {k: v for k, v in sd.items()
                  if not k.startswith(("convOa.", "denseOa.", "denseOb."))}
        return load_state(rn, sd)

    @torch.inference_mode()
    def solve_pose(self, refined: torch.Tensor, valid: torch.Tensor):
        """Batched PnP on the pipeline's camera: corners (N, n_ids, 2) float32
        and their mask, on the pipeline's device → (ok, rvec, tvec,
        reproj_rms). On the card the solver is replayed from a CUDA graph
        captured once per batch size: it is several thousand small
        operations with static shapes and no host synchronisation, and run
        eagerly it is bound by the host's launches. The outputs are then the
        graph's own buffers, valid until the next call, so one pipeline
        serves one thread at a time."""
        solve = lambda r, v: _solve(self.object_points, r, v, self._K, self._dist,
                                    self.pnp_iters)
        if refined.device.type != "cuda":
            return solve(refined, valid)
        n = refined.shape[0]
        entry = self._pose_graphs.pop(n, None)
        if entry is None:
            if len(self._pose_graphs) >= _MAX_POSE_GRAPHS:      # drop the oldest
                self._pose_graphs.pop(next(iter(self._pose_graphs)))
            with torch.cuda.device(refined.device):
                entry = self._capture_pose(solve, refined, valid)
        self._pose_graphs[n] = entry                            # newest last
        graph, r_in, v_in, out = entry
        r_in.copy_(refined)
        v_in.copy_(valid)
        graph.replay()
        return out

    @staticmethod
    def _capture_pose(solve, refined, valid):
        """(graph, its two input buffers, its outputs) of ``solve`` at the
        shapes of ``refined``/``valid``, captured on the current device."""
        r_in, v_in = torch.zeros_like(refined), torch.zeros_like(valid)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):           # warm-up outside the capture
            solve(r_in, v_in)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA calls (a server's upload
        # thread) do not invalidate the capture
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = solve(r_in, v_in)
        return graph, r_in, v_in, out

    @torch.inference_mode()
    def forward_device(self, frames, with_pose: bool = False):
        """The device-level entry: frames (a tensor already on the
        pipeline's device, or anything :func:`two_stage_forward` takes) →
        the tuple of :meth:`detect` or :meth:`detect_with_pose` as tensors on
        the device. Everything is enqueued on the current stream; nothing is
        copied to the host and the host waits for nothing. With pose on the
        card the last four are the pose graph's own buffers
        (:meth:`solve_pose`): read or copy them, in stream order, before the
        next call."""
        if with_pose and self.camera is None:
            raise ValueError("InferencePipeline was built without a Camera")
        common = dict(min_margin=self.min_margin, rn_decode=self.rn_decode,
                      fused_head=self.fused_head, folded=self.folded,
                      return_filled=True, device=self.device, **self._geom)
        if self.hires:
            out = two_stage_forward_hires(self.detector, self.refinenet, frames,
                                          self.n_ids, scale=self.hires_scale, **common)
        else:
            if not with_pose:       # the pose path is per id: one slot
                common.update(decode_capacity=self.decode_capacity)
            out = two_stage_forward(self.detector, self.refinenet, frames,
                                    self.n_ids, **common)
        keypoints, valid, refined, filled = out
        if not with_pose:
            return keypoints, valid, refined
        # the pose comes from the measured detections only (full_forward)
        return (keypoints, valid, refined,
                *self.solve_pose(refined.float(), valid & ~filled))

    def _forward(self, frames, with_pose: bool):
        return tuple(t.cpu().numpy() for t in self.forward_device(frames, with_pose))

    def detect(self, frames: np.ndarray):
        """frames: (N,H,W,3) BGR uint8 / (N,H,W) gray →
        (keypoints, valid, refined) numpy arrays."""
        return self._forward(frames, with_pose=False)

    def detect_with_pose(self, frames: np.ndarray):
        """→ (keypoints, valid, refined, ok, rvec, tvec, reproj_rms)."""
        return self._forward(frames, with_pose=True)

    def input_coords(self, xy: np.ndarray) -> np.ndarray:
        """Map pipeline-output coordinates to INPUT-frame pixel units: the
        hi-res tap reports corners in pooled-view (low-res) units, and
        ``x_hi = s·x_lo + (s−1)/2`` puts them on the caller's full-resolution
        frame. Identity for the base-resolution pipeline."""
        xy = np.asarray(xy)
        s = self.hires_scale
        return s * xy + (s - 1) * 0.5 if self.hires else xy

    def keypoint_array(self, refined: np.ndarray, valid: np.ndarray):
        """One frame's keypoints + mask → (M, 3) float ``[x, y, id]`` rows
        sorted by id. Takes both decode shapes: (n_ids, 2)/(n_ids,), or
        (n_ids, K, 2)/(n_ids, K) from a ``decode_capacity > 1`` pipeline,
        where duplicate slots become duplicate rows with the same id."""
        refined = np.asarray(refined)
        valid = np.asarray(valid)
        if valid.ndim == 2:     # capacity-K decode: flatten slots
            ids, slots = np.nonzero(valid)
            rows = refined[ids, slots]
        else:
            ids = np.nonzero(valid)[0]
            rows = refined[ids]
        return np.concatenate([rows, ids[:, None].astype(refined.dtype)], axis=1)


__all__ = ["Camera", "InferencePipeline", "load_pipeline", "load_detector_any",
           "load_model_variables",
           "is_quantized_npz", "two_stage_forward", "two_stage_forward_hires",
           "full_forward", "full_forward_hires", "resolve_device"]

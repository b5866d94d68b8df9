"""Pair matching: SuperPoint keypoints and descriptors, then LightGlue, on
the device (``cvg/LightGlue``'s ``SuperPoint`` + ``LightGlue`` extractor and
matcher, batched over pairs).

:class:`MatchPipeline` holds both models; its :meth:`~MatchPipeline.
forward_device` takes 2P gray uint8 frames, rows 2i and 2i+1 forming pair
i, and returns one row per frame: its keypoints, their scores, the index
of each keypoint's match in the partner frame (−1: none) and the match's
score. It is the same kind of entry as ``InferencePipeline.forward_device``,
so ``serving.pipelined_map`` serves it as it serves that.

Spans (``profiling``), with events on the stream on the card:
``match.superpoint`` (the network), ``match.keypoints`` (scores, NMS,
selection, descriptor sampling), ``match.lightglue`` (the layers, with a
``match.attention`` inside for each attention call) and ``match.assign``
(the assignment and the mutual filter). Counters: ``match.pairs`` and
``match.layers`` (layers run, over all calls).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from deepcharuco_tpu_torch import profiling
from deepcharuco_tpu_torch._device import resolve_device
from deepcharuco_tpu_torch.models import lightglue, superpoint
from deepcharuco_tpu_torch.ops import keypoints as kp


class MatchPipeline:
    """SuperPoint + LightGlue on ``device`` (None → the card; without one
    that raises unless ``device="cpu"``), from state dicts in the published
    layout (float32 tensors). The settings are those of ``lightglue/
    superpoint.py`` and ``lightglue/lightglue.py`` (``max_num_keypoints``
    as the extractor is built for LightGlue); ``compute_dtype`` is the
    networks' precision (scores, NMS, descriptor sampling and the assignment
    stay float32)."""

    def __init__(self, superpoint_state: Dict[str, torch.Tensor],
                 lightglue_state: Dict[str, torch.Tensor], *,
                 max_num_keypoints: int = 2048, nms_radius: int = 4,
                 detection_threshold: float = 0.0005, remove_borders: int = 4,
                 descriptor_dim: int = 256, n_layers: int = 9, num_heads: int = 4,
                 filter_threshold: float = 0.1, compute_dtype=torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.k, self.nms_radius = max_num_keypoints, nms_radius
        self.threshold, self.border = detection_threshold, remove_borders
        self.n_layers = n_layers
        sp = superpoint.SuperPoint(descriptor_dim, compute_dtype)
        sp.load_state_dict(superpoint.state_from_published(superpoint_state))
        lg = lightglue.LightGlue(descriptor_dim, n_layers, num_heads, filter_threshold,
                                 compute_dtype)
        lg.load_state_dict(lightglue.state_from_published(lightglue_state, n_layers))
        self.superpoint = sp.to(self.device).eval()
        self.lightglue = lg.to(self.device).eval()
        profiling.anchor(self.device)

    def keypoints(self, logits: torch.Tensor, dense: torch.Tensor):
        """(keypoints, scores, valid, descriptors) from SuperPoint's heads."""
        scores = kp.simple_nms(kp.score_map(logits), self.nms_radius)
        kpts, kscores, valid = kp.select(scores, self.k, self.threshold, self.border)
        return kpts, kscores, valid, kp.sample_descriptors(kpts, dense)

    @torch.inference_mode()
    def forward_device(self, frames) -> Tuple[torch.Tensor, ...]:
        """Gray uint8 frames (2P, H, W), H and W multiples of 8 (a tensor on
        the pipeline's device, or anything ``torch.as_tensor`` takes) →
        (keypoints (2P, k, 2) float32 (x, y) pixels, keypoint scores (2P, k),
        matches (2P, k) int32, match scores (2P, k)) on the device. A slot
        that holds no keypoint has keypoint (0, 0), score 0 and match −1.
        Everything is enqueued on the current stream; nothing is copied to
        the host."""
        frames = torch.as_tensor(frames, device=self.device)
        n, h, w = frames.shape
        if n % 2 or h % 8 or w % 8:
            raise ValueError(f"MatchPipeline takes pairs of frames whose sides are multiples "
                             f"of 8, got {tuple(frames.shape)}")
        cuda = self.device.type == "cuda"
        with profiling.span("match.superpoint", device=cuda):
            logits, dense = self.superpoint(frames.float() / 255.0)
        with profiling.span("match.keypoints", device=cuda):
            kpts, kscores, valid, desc = self.keypoints(logits, dense)
        with profiling.span("match.lightglue", device=cuda):
            x = self.lightglue.layers(kpts, desc, valid, (h, w))
        with profiling.span("match.assign", device=cuda):
            matches, mscores = self.lightglue.assign(x, valid)
        profiling.count("match.pairs", n // 2)
        profiling.count("match.layers", self.n_layers)
        return kpts, kscores, matches, mscores

    def match(self, frames: np.ndarray) -> Tuple[np.ndarray, ...]:
        """:meth:`forward_device` with numpy in and out."""
        return tuple(t.cpu().numpy() for t in self.forward_device(frames))

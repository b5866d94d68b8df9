"""Training and validation metrics (``deepcharuco_tpu.train.metrics``).

:func:`detector_metrics` decodes the predicted heads through
``ops.decode.pred_to_keypoints``: the decode kernel (``csrc/decode.cu``) on
the card, its plain version on the CPU. The winner per id is the claiming
cell of highest ids-head confidence, ties to the lowest cell, which is the
JAX package's ``label_to_keypoints(pred_argmax(...), scores=max ids)``.
The targets decode through ``label_to_keypoints``.
"""

from __future__ import annotations

import torch

from deepcharuco_tpu_torch.ops.decode import (heatmap_argmax2d, label_to_keypoints,
                                              pred_to_keypoints)


def detector_metrics(loc_hat, ids_hat, loc_target, ids_target, dust_bin_ids: int,
                     px_margin: float = 3.0):
    """→ dict(l2_pixels, match_ratio, n_pred, n_target) of 0-d tensors.

    loc_hat/ids_hat: NHWC float32 logits; loc_target/ids_target: (N, Hc, Wc)
    int maps. ``l2_pixels``: the mean distance over the ids found in both,
    per frame; ``match_ratio``: the share of target ids within
    ``px_margin``; both averaged over the frames that have a target."""
    kp_pred, v_pred = pred_to_keypoints(loc_hat.contiguous(), ids_hat.contiguous(),
                                        dust_bin_ids)
    kp_tgt, v_tgt = label_to_keypoints(loc_target, ids_target, dust_bin_ids)
    both = v_pred & v_tgt
    d = torch.linalg.norm(kp_pred - kp_tgt, dim=-1)
    d = torch.where(both, d, 0.0)
    n_found = both.sum(dim=-1)
    n_tgt = v_tgt.sum(dim=-1)
    has = n_tgt > 0
    l2_per_sample = d.sum(dim=-1) / n_found.clamp(min=1)
    ratio_per_sample = (both & (d < px_margin)).sum(dim=-1) / n_tgt.clamp(min=1)
    denom = has.sum().clamp(min=1)
    return {
        "l2_pixels": torch.where(has, l2_per_sample, 0.0).sum() / denom,
        "match_ratio": torch.where(has, ratio_per_sample, 0.0).sum() / denom,
        "n_pred": v_pred.sum(dim=-1).float().mean(),
        "n_target": v_tgt.sum(dim=-1).float().mean(),
    }


def refinenet_metric(heat_hat, heat_target):
    """Mean L2 between the heatmaps' argmax positions (64×64 grid: pixels at
    8× the original resolution)."""
    if heat_hat.ndim == 4:
        heat_hat = heat_hat[..., 0]
    if heat_target.ndim == 4:
        heat_target = heat_target[..., 0]
    return torch.linalg.norm(heatmap_argmax2d(heat_hat) - heatmap_argmax2d(heat_target),
                             dim=-1).mean()


class MeanAccumulator:
    """Streaming mean of logged scalars. Tensors are summed where they lie
    (a train loop does not wait for the card at every step); :meth:`compute`
    reads the sums."""

    def __init__(self):
        self._sum = {}
        self._n = {}

    def update(self, **scalars):
        for k, v in scalars.items():
            v = v.detach() if isinstance(v, torch.Tensor) else float(v)
            self._sum[k] = self._sum[k] + v if k in self._sum else v
            self._n[k] = self._n.get(k, 0) + 1

    def compute(self):
        return {k: float(self._sum[k]) / self._n[k] for k in self._sum}

    def reset(self):
        self._sum.clear()
        self._n.clear()

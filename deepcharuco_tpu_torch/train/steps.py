"""Training steps for the detector and RefineNet (``deepcharuco_tpu.train.steps``).

Losses as in the JAX package (and the reference's Lightning wrappers):

- detector: ``CE(loc) + CE(ids)`` over the (N, Hc, Wc) class maps, Adam at
  5e-3, with the optional margin-calibration auxiliary (``conf_weight``,
  ``conf_margin``, ``conf_topk`` with its 3×3 corner-neighbourhood
  exclusion, ``conf_fg_topk``);
- RefineNet: MSE on the 64×64 heatmap, Adam at 1e-4, with the optional
  soft-argmax coordinate loss (``coord_weight``) and offset-branch loss
  (``offset_weight``).

``torch.optim.Adam`` takes the place of ``optax.adam``: the same moments, the
same bias corrections, the same ε outside the square root. A
:class:`TrainState` holds the module, its optimizer and the global step;
a train step updates it in place and returns it with the step's scalars,
which stay on the device (reading one waits for the card).

Every step takes ``mesh`` (a ``parallel.mesh.Mesh``, None on one card): the
model runs as one rank of the mesh on this rank's share of the batch, the
gradients are averaged over every rank of the mesh after the backward
pass, and the aux scalars are averaged over ``data``, so that every rank
holds the global loss and applies the gradient of the global mean loss.

Spans (``profiling``), each under the state's step: ``train.forward`` (the
model and the loss), ``train.backward`` (the host blocked while autograd's
thread enqueues the backward pass), ``parallel.grad_all_reduce`` under a
mesh and ``train.update`` (Adam). Counter: ``train.steps``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from deepcharuco_tpu_torch import profiling
from deepcharuco_tpu_torch.models import Detector, RefineNet
from deepcharuco_tpu_torch.ops.decode import soft_argmax_2d


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


# ---------------------------------------------------------------------------
# State creation
# ---------------------------------------------------------------------------

def flax_init_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Re-initialize ``module`` with Flax's defaults, which the JAX trainers
    start from: conv and dense kernels LeCun-normal (a normal truncated at
    ±2σ, variance 1/fan_in), biases 0, BatchNorm scale 1 and bias 0, running
    mean 0 and variance 1. Draws on the CPU from ``seed``; the values, not
    the stream, match Flax's."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = m.weight
                fan_in = w[0].numel()
                # truncated normal with unit variance after truncation (Flax's
                # variance_scaling divides the std by 0.8796…)
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                v = torch.empty(w.shape, dtype=torch.float32)
                torch.nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=gen)
                w.copy_((v * std).to(w.dtype))
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return module


def create_detector_state(det: Detector, lr: float = 5e-3) -> TrainState:
    """Adam at ``lr`` over ``det``'s parameters (on their device), step 0."""
    return TrainState(det, torch.optim.Adam(det.parameters(), lr=lr), 0)


def create_refinenet_state(rn: RefineNet, lr: float = 1e-4) -> TrainState:
    return TrainState(rn, torch.optim.Adam(rn.parameters(), lr=lr), 0)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of NHWC logits against integer maps."""
    return F.cross_entropy(logits.permute(0, 3, 1, 2), labels.long())


def detector_loss_fn(det: Detector, images, loc_labels, ids_labels, train: bool = True,
                     conf_weight: float = 0.0, conf_margin: float = 4.0,
                     conf_topk: int = 0, conf_fg_topk: int = 0, mesh=None):
    """CE(loc) + CE(ids) [+ ``conf_weight``·conf]. ``train=True`` runs the
    model on batch statistics and updates its running ones. Returns
    (loss, aux scalars, model outputs). Under ``mesh`` the outputs are whole
    grids of this rank's data shard (the detector gathers its trunk), so the
    losses and the conf hinges' per-image top-k see whole images."""
    out = det(images, train=train, mesh=mesh)
    loss_loc = _ce(out["loc"], loc_labels)
    loss_ids = _ce(out["ids"], ids_labels)
    loss = loss_loc + loss_ids
    aux = {"loss": loss, "loss_loc": loss_loc, "loss_ids": loss_ids}
    if conf_weight > 0.0:
        loss_conf = _conf_loss(out, ids_labels.long(), conf_margin, conf_topk, conf_fg_topk)
        loss = loss + conf_weight * loss_conf
        aux = {**aux, "loss": loss, "loss_conf": loss_conf}
    return loss, aux, out


def _conf_loss(out, ids_labels, margin, topk, fg_topk):
    """The margin-calibration auxiliary of ``deepcharuco_tpu.train.steps``:
    background cells' best id (and loc position) logit at least ``margin``
    under the dustbin's, corner cells' true id logit at least ``margin``
    over its best rival; ``topk``/``fg_topk`` add each image's worst
    background cells outside the corners' 3×3 neighbourhood / worst corner
    cells. Maxima are ``amax``, which splits the gradient between ties as
    ``jnp.max`` does."""
    ids_hat, loc_hat = out["ids"], out["loc"]
    n_ids = ids_hat.shape[-1] - 1
    dust = ids_hat[..., n_ids]
    best_id = ids_hat[..., :n_ids].amax(dim=-1)
    is_bg = ids_labels == n_ids
    bg_viol = F.relu(best_id - dust + margin)
    true_logit = torch.gather(ids_hat, -1, ids_labels[..., None])[..., 0]
    onehot = F.one_hot(ids_labels, n_ids + 1).to(ids_hat.dtype)
    rival = (ids_hat - onehot * 1e9).amax(dim=-1)
    fg_viol = F.relu(rival - true_logit + margin)
    loss = torch.where(is_bg, bg_viol, fg_viol).mean()
    loc_bg_viol = F.relu(loc_hat[..., :64].amax(dim=-1) - loc_hat[..., 64] + margin)
    loss = loss + torch.where(is_bg, loc_bg_viol, 0.0).mean()
    n = ids_hat.shape[0]
    if topk > 0:
        corner = (~is_bg).float()[:, None]                      # (N, 1, Hc, Wc)
        near_corner = F.max_pool2d(corner, 3, stride=1, padding=1)[:, 0]
        minable = is_bg & (near_corner == 0.0)
        worst = torch.where(minable, bg_viol + loc_bg_viol, 0.0).reshape(n, -1)
        loss = loss + torch.topk(worst, topk, dim=-1).values.mean()
    if fg_topk > 0:
        fg_worst = torch.where(~is_bg, fg_viol, 0.0).reshape(n, -1)
        loss = loss + torch.topk(fg_worst, fg_topk, dim=-1).values.mean()
    return loss


def refinenet_loss_fn(rn: RefineNet, patches, heatmaps, train: bool = True,
                      coord_weight: float = 0.0, offset_weight: float = 0.0, mesh=None):
    """MSE on the heatmaps [+ ``coord_weight``·soft-argmax position error
    in image px + ``offset_weight``·offset-branch error]; the targets'
    positions come from soft-argmaxing the target Gaussians. Returns
    (loss, aux scalars, predicted heatmaps)."""
    out = rn(patches, train=train, mesh=mesh)
    heat = out["heat"] if isinstance(out, dict) else out
    loss = ((heat - heatmaps) ** 2).mean()
    aux = {"loss": loss}
    if coord_weight > 0.0:
        pred_xy = soft_argmax_2d(heat) / 8.0
        true_xy = soft_argmax_2d(heatmaps) / 8.0
        loss_coord = ((pred_xy - true_xy) ** 2).sum(dim=-1).mean()
        loss = loss + coord_weight * loss_coord
        aux = {**aux, "loss": loss, "loss_coord": loss_coord}
    if offset_weight > 0.0:
        true_off = (soft_argmax_2d(heatmaps) - 32.0) / 8.0
        loss_off = ((out["offset"] - true_off) ** 2).sum(dim=-1).mean()
        loss = loss + offset_weight * loss_off
        aux = {**aux, "loss": loss, "loss_offset": loss_off}
    return loss, aux, heat


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _update(state: TrainState, loss: torch.Tensor, aux,
            mesh=None) -> Tuple[TrainState, Dict]:
    with profiling.span("train.backward", state.step):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    aux = {k: v.detach() for k, v in aux.items()}
    if mesh is not None:
        # Each rank's loss is its data shard's mean, and the spatial gather's
        # backward sums over 'spatial': the mean over all n_d·n_s ranks of
        # their gradients is the gradient of the global mean loss.
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        scalars = torch.stack(list(aux.values()))
        with profiling.span("parallel.grad_all_reduce", state.step):
            dist.all_reduce(flat, group=mesh.world)
            dist.all_reduce(scalars, group=mesh.data)
        flat /= mesh.size
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
        aux = dict(zip(aux, (scalars / mesh.shape["data"]).unbind(0)))
    with profiling.span("train.update", state.step):
        state.optimizer.step()
    state.step += 1
    profiling.count("train.steps")
    return state, aux


def make_detector_train_step(conf_weight: float = 0.0, conf_margin: float = 4.0,
                             conf_topk: int = 0, conf_fg_topk: int = 0) -> Callable:
    """``step(state, images, loc, ids, mesh=None) → (state, aux)``: one Adam
    step."""
    def step(state: TrainState, images, loc_labels, ids_labels, mesh=None):
        with profiling.span("train.forward", state.step):
            loss, aux, _ = detector_loss_fn(state.model, images, loc_labels, ids_labels,
                                            conf_weight=conf_weight, conf_margin=conf_margin,
                                            conf_topk=conf_topk, conf_fg_topk=conf_fg_topk,
                                            mesh=mesh)
        return _update(state, loss, aux, mesh)

    return step


def make_refinenet_train_step(coord_weight: float = 0.0,
                              offset_weight: float = 0.0) -> Callable:
    """``step(state, patches, heatmaps, mesh=None) → (state, aux)``: one Adam
    step."""
    def step(state: TrainState, patches, heatmaps, mesh=None):
        with profiling.span("train.forward", state.step):
            loss, aux, _ = refinenet_loss_fn(state.model, patches, heatmaps,
                                             coord_weight=coord_weight,
                                             offset_weight=offset_weight, mesh=mesh)
        return _update(state, loss, aux, mesh)

    return step


def make_detector_eval_step() -> Callable:
    """``step(state, images, loc, ids) → (aux, outputs)``, running
    statistics, no gradients."""
    def step(state: TrainState, images, loc_labels, ids_labels):
        with torch.inference_mode():
            _, aux, out = detector_loss_fn(state.model, images, loc_labels, ids_labels,
                                           train=False)
        return aux, out

    return step


def make_refinenet_eval_step(offset_weight: float = 0.0) -> Callable:
    """``step(state, patches, heatmaps) → (aux, heatmaps)``, running
    statistics, no gradients."""
    def step(state: TrainState, patches, heatmaps):
        with torch.inference_mode():
            _, aux, heat = refinenet_loss_fn(state.model, patches, heatmaps, train=False,
                                             offset_weight=offset_weight)
        return aux, heat

    return step


def state_variables(state: TrainState) -> Dict:
    """The state's model as JAX-layout ``{"params", "batch_stats"}`` numpy
    variables (the shipped ``.npz`` tree)."""
    from deepcharuco_tpu_torch import weights as W

    sd = state.model.state_dict()
    if isinstance(state.model, Detector):
        return W.detector_variables(sd)
    return W.refinenet_variables(sd)


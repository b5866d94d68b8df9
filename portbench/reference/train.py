"""The detector's training step in plain PyTorch: the forward pass on batch
statistics, CE(loc) + CE(ids), autograd, and Adam written out
(bias-corrected moments, ε outside the square root). Followed for the
first steps from the same initial parameters on the same batches as the
program, and the readings that compare the two:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first step's gradient, leaf by leaf, as the gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``update_gap``: the same for each leaf's change over the checked steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (biases that feed a BatchNorm, moved by round-off alone);
- ``grad_gap_channel_median``: the first gradient's norm gap taken output
  channel by output channel (a kernel's slice along its first axis, an
  element of a vector) over the larger of the reference's norm of that
  channel and of the median channel, over the same leaves, and the median
  of those gaps. A norm's gap is one projection of the rounding error, so
  one leaf's swings from nought to twice its typical size from seed to
  seed; the median over some thousand channels does not;
- ``grad_gap_bf16_share``: that median channel gap over the one the
  reference itself shows with its convolutions rounded to bfloat16 (the
  precision below the configuration's), on the same batch: how much of
  bfloat16's rounding the program's first gradient carries. The data set
  the size of a rounding's effect (a BatchNorm after a convolution makes
  its kernel's gradient a sum that nearly cancels), the same for both, so
  the share holds from seed to seed where the gap moves twofold.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference import nets


def steps(P0: Dict[str, torch.Tensor], batches, lr: float, betas, eps: float,
          q=nets.identity):
    """Adam steps from ``P0`` on ``batches`` [(images (B, H, W, 1), loc,
    ids)], returning (losses [float], first gradient {name: tensor}, final
    parameters {name: tensor})."""
    P = {k: v.detach().clone().float().requires_grad_(True) for k, v in P0.items()}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    b1, b2 = betas
    losses: List[float] = []
    first = None
    for t, (images, loc_l, ids_l) in enumerate(batches, start=1):
        x = images.permute(0, 3, 1, 2).float()
        loc, ids = nets.detector_train(P, x, q)
        loss = F.cross_entropy(loc, loc_l.long()) + F.cross_entropy(ids, ids_l.long())
        grads = torch.autograd.grad(loss, list(P.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = dict(zip(P, grads))
            if first is None:
                first = {k: t_.clone() for k, t_ in g.items()}
            for k, p in P.items():
                m[k].mul_(b1).add_((1 - b1) * g[k])
                v2[k].mul_(b2).add_((1 - b2) * g[k] * g[k])
                mhat = m[k] / (1 - b1 ** t)
                vhat = v2[k] / (1 - b2 ** t)
                p.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
    return losses, first, {k: p.detach() for k, p in P.items()}


def _leaf_norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def _median(vals) -> float:
    s = sorted(vals)
    return s[len(s) // 2]


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              leaves) -> Dict[str, float]:
    """{leaf: |‖got‖ − ‖want‖| / max(‖want‖, median ‖want‖)} over ``leaves``."""
    g, w = _leaf_norms(got), _leaf_norms(want)
    med = _median([w[k] for k in leaves])
    return {k: abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in leaves}


def channel_gap_median(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                       leaves) -> float:
    """Median over the output channels of ``leaves`` of |‖got‖ − ‖want‖| /
    max(‖want‖, median channel's ‖want‖)."""
    def norms(d):
        return torch.cat([d[k].double().reshape(d[k].shape[0], -1).norm(dim=1) for k in leaves])

    g, w = norms(got), norms(want)
    return float(((g - w).abs() / torch.clamp(w, min=float(w.median()))).median())


def judge(program: dict, reference: dict) -> Dict[str, float]:
    """Readings from the program's record (``losses``, ``grad`` of step 1,
    ``start`` and ``end`` parameters) and the reference's (``losses``,
    ``grad``, ``end``, and where given ``grad_bf16``, its first gradient
    with bfloat16 convolutions) of the same steps: the loss's relative gap
    at the first step and at the worst step; the first gradient's and the
    change's norm gaps at the worst leaf and at the median leaf; the first
    gradient's median channel gap, and its share of bfloat16's."""
    rel = [abs(a - b) / abs(b) for a, b in zip(program["losses"], reference["losses"])]
    gnorm = _leaf_norms(reference["grad"])
    med = _median(gnorm.values())
    moving = [k for k, n in gnorm.items() if n >= 1e-3 * med]
    delta = lambda rec: {k: rec["end"][k].double() - program["start"][k].double()
                         for k in moving}
    grad = leaf_gaps(program["grad"], reference["grad"], list(gnorm))
    update = leaf_gaps(delta(program), delta(reference), moving)
    channel = channel_gap_median(program["grad"], reference["grad"], moving)
    out = {"loss_gap_step1": rel[0], "loss_gap": max(rel),
           "grad_gap": max(grad.values()), "grad_gap_median": _median(grad.values()),
           "grad_gap_channel_median": channel,
           "update_gap": max(update.values()), "update_gap_median": _median(update.values())}
    if "grad_bf16" in reference:
        out["grad_gap_bf16_share"] = channel / channel_gap_median(
            reference["grad_bf16"], reference["grad"], moving)
    return out

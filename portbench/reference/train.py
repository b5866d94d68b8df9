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
  median leaf's (biases that feed a BatchNorm, moved by round-off alone).
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


def judge(program: dict, reference: dict) -> Dict[str, float]:
    """Readings from the program's record (``losses``, ``grad`` of step 1,
    ``start`` and ``end`` parameters) and the reference's (``losses``,
    ``grad``, ``end``) of the same steps: the loss's relative gap at the
    first step and at the worst step; the first gradient's and the change's
    norm gaps at the worst leaf and at the median leaf."""
    rel = [abs(a - b) / abs(b) for a, b in zip(program["losses"], reference["losses"])]
    gnorm = _leaf_norms(reference["grad"])
    med = _median(gnorm.values())
    moving = [k for k, n in gnorm.items() if n >= 1e-3 * med]
    delta = lambda rec: {k: rec["end"][k].double() - program["start"][k].double()
                         for k in moving}
    grad = leaf_gaps(program["grad"], reference["grad"], list(gnorm))
    update = leaf_gaps(delta(program), delta(reference), moving)
    return {"loss_gap_step1": rel[0], "loss_gap": max(rel),
            "grad_gap": max(grad.values()), "grad_gap_median": _median(grad.values()),
            "update_gap": max(update.values()), "update_gap_median": _median(update.values())}

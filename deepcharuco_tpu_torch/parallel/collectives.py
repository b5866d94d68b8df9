"""Differentiable collectives for the mesh (no counterpart in the JAX
package, where XLA inserts them from the shardings).

- :func:`all_reduce` — the sum over a group; its gradient is the sum of the
  group's gradients.
- :func:`all_gather` — the group's tensors joined along a dimension, in
  group order; its gradient is this rank's part of the group's summed
  gradient.
- :func:`halo_rows` — a tensor's neighbours' rows across the spatial axis.

Each is a ``torch.autograd.Function`` whose backward uses ``all_reduce``
only: gloo takes CUDA tensors for ``broadcast``, ``all_reduce`` and
``all_gather`` but not for ``reduce_scatter``, so the same code runs under
NCCL, under gloo on the CPU and under gloo on the card. Every rank of a
group must call the same collectives in the same order, in the forward and
in the backward pass, which holds when every rank runs the same program.
Each collective runs in a span of the port's recorder (``profiling``:
``parallel.all_reduce``, ``parallel.all_gather``; the train step's gradient
average is ``parallel.grad_all_reduce``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from deepcharuco_tpu_torch import profiling


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        with profiling.span("parallel.all_reduce"):
            dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        with profiling.span("parallel.all_reduce"):
            dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        x = x.contiguous()
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        with profiling.span("parallel.all_gather"):
            dist.all_gather(parts, x, group=group)
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        ctx.index = dist.get_group_rank(group, dist.get_rank()) if group is not None \
            else dist.get_rank()
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        with profiling.span("parallel.all_reduce"):
            dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` on every rank of it, differentiably."""
    return _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """The group's ``x`` joined along ``dim`` in group order, differentiably.
    Every rank's ``x`` has the same shape."""
    return _AllGather.apply(x, dim, group)


def halo_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """(N, C, h, W) rows of this rank → (N, C, h + 2, W): the row above from
    the spatial neighbour before it and the row below from the one after
    it. The frame's first and last rows get zeros beyond them, which is SAME
    padding. Every rank of the spatial group gathers every rank's top and
    bottom rows and keeps its neighbours'."""
    n_s, s = mesh.shape["spatial"], mesh.coords[1]
    edges = all_gather(torch.cat([x[:, :, :1], x[:, :, -1:]], 2), 2, mesh.spatial)
    zeros = torch.zeros_like(x[:, :, :1])
    above = edges[:, :, 2 * s - 1:2 * s] if s > 0 else zeros
    below = edges[:, :, 2 * s + 2:2 * s + 3] if s < n_s - 1 else zeros
    return torch.cat([above, x, below], 2)

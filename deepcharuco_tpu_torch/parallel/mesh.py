"""Several cards: the ('data', 'spatial') mesh and the sharded programs
(``deepcharuco_tpu.parallel.mesh``), on ``torch.distributed``.

The JAX package runs one controller whose program XLA partitions over a
device mesh. Here every rank is a process (``torchrun``, one per card) that
runs the same program on its own part of the batch, and the collectives
are ``torch.distributed`` calls (:mod:`.collectives`). The semantics are
the JAX package's, global:

- BatchNorm's batch statistics reduce over the whole batch, not per shard;
- the gradient is that of the global mean loss: each rank's loss is the
  mean over its data shard, the spatial gather's backward sums over
  ``spatial``, and the gradients averaged over all ``n_d·n_s`` ranks are
  that gradient (``train.steps``);
- parameters and optimizer state stay replicated: every rank applies the
  same averaged gradient to the same weights (:func:`replicate` makes them
  equal at the start);
- the loss the step returns is the global loss.

Axes:

- ``data`` — dimension 0 of every batch array is split over the data axis
  when it divides, else left whole on every rank (with a warning).
- ``spatial`` — image height. Every rank holds its data shard's frames
  whole; the detector convolves only its own rows of them
  (:meth:`~deepcharuco_tpu_torch.models.Detector.forward` with ``mesh``),
  exchanging one halo row with each neighbour before each 3×3 conv, and
  gathers the trunk before the heads, so the heads, the loss, the decode
  and the patch gather see whole frames. The height is split when
  ``H % (8·n_s) == 0`` (``models.detector.splits_rows``), so that every
  rank's rows stay even through the three 2×2 pools; otherwise it is left
  whole, with a warning that names the axis. Patch-shaped data is never
  split spatially.

A rank's batch comes from the same global batch on every rank: every rank
is handed (or synthesizes, from a generator seeded alike) the whole batch
and keeps its own rows. The ranks of one spatial group must hold the same
samples; a batch that only one of them can build (a host stream whose
draws are not seeded alike on the ranks) reaches the others through
:func:`broadcast_spatial`.

Run under ``torchrun`` (``python -m torch.distributed.run --nproc-per-node
N ...``), which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; call
:func:`init_distributed`, then :func:`make_mesh`.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from deepcharuco_tpu_torch._device import resolve_device
from deepcharuco_tpu_torch.data.device_synth import share_rows


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a ('data', 'spatial') mesh of ranks: rank
    ``r`` of the mesh sits at ``(r // n_s, r % n_s)``.

    ``world`` is the group of the mesh's ranks, ``data`` the group of the
    ranks at this rank's spatial index (they hold different samples),
    ``spatial`` the group at its data index (they hold the same samples,
    different rows). ``shape`` reads as JAX's ``mesh.shape[...]``."""

    shape: Dict[str, int]
    coords: Tuple[int, int]
    ranks: Tuple[int, ...]
    world: object
    data: object
    spatial: object
    device: torch.device

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["spatial"]


def _warn_unsharded(axis: str, dim_size: int, n: int, what: str, factor: int = 1) -> None:
    """A divisibility miss leaves the dimension whole on every rank of the
    axis: say so. Python shows each call site's warning once."""
    by = f"{factor} × mesh axis" if factor > 1 else "mesh axis"
    warnings.warn(
        f"{what}: size {dim_size} not divisible by {by} '{axis}' ({n}) — "
        f"dimension left UNPARTITIONED (replicated); that axis does no work",
        stacklevel=3)


def init_distributed(device=None, init_method: Optional[str] = None) -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``; one process alone when they are unset)
    and return this rank's device.

    ``device`` None means the card: ``cuda:(LOCAL_RANK % device_count())``;
    ``"cpu"`` runs on the CPU. The backend is NCCL when every rank of the
    host has a card of its own, else gloo (ranks that share a card, or the
    CPU); it is printed. ``init_method`` defaults to ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``, which ``torchrun`` sets); pass
    ``file://<path>`` for ranks started by hand."""
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        if local_world <= torch.cuda.device_count():
            backend = "nccl"
    print(f"torch.distributed: rank {rank} of {world}, backend {backend}, device {dev}"
          + (" (ranks share a card)" if dev.type == "cuda" and backend == "gloo" else ""),
          flush=True)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world,
                            device_id=dev if backend == "nccl" else None)
    return dev


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              devices: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """Build a ('data', 'spatial') mesh over the ranks ``devices`` (default:
    every rank of the initialised process group); this rank computes on
    ``device`` (None → the card this rank was given by
    :func:`init_distributed`). Every rank of the process group must call
    it, with the same arguments."""
    if devices is None:
        devices = list(range(dist.get_world_size()))
    devices = list(devices)
    if n_data is None:
        n_data = len(devices) // n_spatial
    if n_data < 1 or n_spatial < 1:
        raise ValueError(
            f"mesh {n_data}x{n_spatial} is empty — n_spatial ({n_spatial}) "
            f"likely exceeds the device count ({len(devices)})")
    if n_data * n_spatial > len(devices):
        raise AssertionError(
            f"mesh {n_data}x{n_spatial} needs more than {len(devices)} devices")
    ranks = devices[:n_data * n_spatial]
    me = dist.get_rank()
    if device is None:
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else resolve_device(None)
    else:
        dev = resolve_device(device)
    # every rank creates every group, in the same order
    world = dist.new_group(ranks) if len(ranks) < dist.get_world_size() else dist.group.WORLD
    groups = {}
    for s_ in range(n_spatial):
        groups["data", s_] = dist.new_group([ranks[d_ * n_spatial + s_]
                                             for d_ in range(n_data)])
    for d_ in range(n_data):
        groups["spatial", d_] = dist.new_group(ranks[d_ * n_spatial:(d_ + 1) * n_spatial])
    if me not in ranks:
        raise ValueError(f"rank {me} is not one of the mesh's ranks {ranks}")
    d, s = divmod(ranks.index(me), n_spatial)
    data, spatial = groups["data", s], groups["spatial", d]
    return Mesh({"data": n_data, "spatial": n_spatial}, (d, s), tuple(ranks), world, data,
                spatial, dev)


def _data_rows(mesh: Mesh, n: int, what: str) -> Tuple[int, int]:
    """This rank's rows [lo, hi) of a global batch of ``n``: its share over
    ``data``, or all of them (with a warning) when ``n`` does not divide."""
    n_d = mesh.shape["data"]
    if n % n_d and n_d > 1:
        _warn_unsharded("data", n, n_d, what)
    return share_rows(n, (mesh.coords[0], n_d))


def _check_height(mesh: Mesh, height: int, what: str) -> None:
    from deepcharuco_tpu_torch.models.detector import splits_rows

    n_s = mesh.shape["spatial"]
    if n_s > 1 and not splits_rows(mesh, height):
        _warn_unsharded("spatial", height, n_s, what, factor=8)


def shard_batch(mesh: Mesh, batch, spatial_dim: Optional[int] = 1):
    """This rank's share of a global batch (a tensor, or a tuple, list or
    dict of them, the same on every rank): dimension 0 over ``data``.
    Dimension ``spatial_dim`` of the images (4-dimensional arrays) is the
    height that the detector splits over ``spatial`` by itself; it stays
    whole here, and a height that cannot be split is warned about
    (``spatial_dim=None``: patch-shaped data, never split)."""
    def put(x):
        lo, hi = _data_rows(mesh, x.shape[0], "shard_batch")
        if spatial_dim is not None and x.ndim == 4:
            _check_height(mesh, x.shape[spatial_dim], "shard_batch")
        return x[lo:hi]

    return _tree_map(put, batch)


def shard_frames(mesh: Mesh, frames):
    """This rank's share of a frame batch (N, H, W[, C]): its rows over
    ``data``, whole in height (split over ``spatial`` by the detector when
    ``models.detector.splits_rows``)."""
    lo, hi = _data_rows(mesh, frames.shape[0], "shard_frames")
    if frames.ndim > 1:
        _check_height(mesh, frames.shape[1], "shard_frames")
    return frames[lo:hi]


def replicate(mesh: Mesh, module_or_state):
    """Make the parameters and buffers of a module (or of a
    ``train.TrainState``'s model) equal on every rank of the mesh: rank 0 of
    the mesh broadcasts its own. Returns its argument."""
    module = getattr(module_or_state, "model", module_or_state)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=mesh.ranks[0], group=mesh.world)
    return module_or_state


def broadcast_spatial(mesh: Mesh, batch):
    """The batch of the first rank of this rank's spatial group, on every
    rank of that group: ``batch`` is a dict of tensors on that rank (on
    ``mesh.device``) and None on the others, which build nothing and
    receive its tensors (shapes and dtypes first, then the data)."""
    src = mesh.ranks[mesh.coords[0] * mesh.shape["spatial"]]
    spec = [None if batch is None else
            {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}]
    dist.broadcast_object_list(spec, src=src, group=mesh.spatial)
    out = {}
    for k, (shape, dtype) in spec[0].items():
        t = (batch[k].contiguous() if batch is not None
             else torch.empty(shape, dtype=dtype, device=mesh.device))
        dist.broadcast(t, src=src, group=mesh.spatial)
        out[k] = t
    return out


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def synth_scan_program(step_fn, batch_fn, fused_steps: int = 1):
    """``program(state, gen) → (state, aux)``: ``fused_steps`` rounds of
    ``step_fn(state, *batch_fn(gen))`` per call, the last round's aux
    returned (the JAX package's ``lax.scan`` over sub-keys; here a plain
    loop, each round drawing its batch from ``gen``). The one wrapper the
    one-card trainers and :func:`sharded_synth_train_program` share."""
    def program(state, gen):
        for _ in range(max(1, fused_steps)):
            state, aux = step_fn(state, *batch_fn(gen))
        return state, aux

    return program


def sharded_train_step(step_fn, mesh: Mesh):
    """A train step for the mesh: ``step(state, *batch) → (state, aux)``
    runs ``step_fn(state, *batch, mesh=mesh)`` (the steps of ``train.steps``
    take the mesh: BatchNorm reduces its statistics over it, the gradients
    are averaged over it, the aux scalars are the global ones). ``batch``
    is this rank's share (:func:`shard_batch`); the state is replicated."""
    def step(state, *batch):
        return step_fn(state, *batch, mesh=mesh)

    return step


def sharded_synth_train_program(step_fn, synthesizer, mesh: Mesh, batch_size: int,
                                fused_steps: int = 1, spatial_dim: Optional[int] = 1):
    """On-card synthesis + train step(s) over the mesh:
    ``program(state, gen) → (state, aux)``.

    Every rank draws the whole batch's random numbers from ``gen`` (seeded
    alike on every rank) and renders only its own samples
    (``synthesizer.batch(gen, batch_size, share=...)``), so the global
    batch is the one-card batch of the same seed, bit for bit, and no rank
    renders another's samples. ``synthesizer`` is one of
    ``data.device_synth``'s; ``spatial_dim=None`` marks patch-shaped data
    (never split spatially), else the images' height is checked against
    ``models.detector.splits_rows``. ``fused_steps`` rounds per call, as
    :func:`synth_scan_program`."""
    share = (mesh.coords[0], mesh.shape["data"])
    _data_rows(mesh, batch_size, "synth_train_program batch")
    if spatial_dim is not None:
        _check_height(mesh, synthesizer.hw[0], "synth_train_program image height")
    return synth_scan_program(sharded_train_step(step_fn, mesh),
                              lambda gen: synthesizer.batch(gen, batch_size, share=share),
                              fused_steps)


class _OnMesh:
    """A detector bound to a mesh: calls pass ``mesh=``; everything else
    (``state_dict``, ``n_ids``, ...) is the detector's own."""

    def __init__(self, module, mesh: Mesh):
        self._module, self._mesh = module, mesh

    def __call__(self, *args, **kwargs):
        return self._module(*args, mesh=self._mesh, **kwargs)

    def __getattr__(self, name):
        return getattr(self._module, name)


@torch.inference_mode()
def _gather_rows(mesh: Mesh, t):
    """The data group's ``t`` joined along dimension 0 (bool tensors travel
    as uint8)."""
    if not isinstance(t, torch.Tensor):
        return t
    x = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape["data"])]
    dist.all_gather(parts, x, group=mesh.data)
    return torch.cat(parts).to(t.dtype)


def sharded_inference(fn, mesh: Mesh, frames_argnum: int = -1):
    """An inference program for the mesh: ``run(*args)`` calls ``fn`` on
    this rank's share of the frame batch (argument ``frames_argnum``, the
    same global batch on every rank) with every
    :class:`~deepcharuco_tpu_torch.models.Detector` argument bound to the
    mesh, so that it splits the height over ``spatial``, and returns the
    global outputs on every rank (each tensor of the result gathered over
    ``data``), as JAX's global arrays are. For ``fn`` = ``lambda det, rn,
    x: two_stage_forward(det, rn, x, ...)`` or ``full_forward``: the patch
    gather, RefineNet, the decodes and the pose run on the data shard's
    whole frames. (The int8 ``QuantDetector`` is not bound: it runs the data
    shard's whole frames on every spatial rank.)"""
    from deepcharuco_tpu_torch.models import Detector

    def run(*args):
        args = list(args)
        frames = args[frames_argnum]
        lo, hi = _data_rows(mesh, frames.shape[0], "sharded_inference batch")
        if frames.ndim > 1:
            _check_height(mesh, frames.shape[1], "sharded_inference height")
        args[frames_argnum] = frames[lo:hi]
        args = [_OnMesh(a, mesh) if isinstance(a, Detector) else a for a in args]
        out = fn(*args)
        if frames.shape[0] % mesh.shape["data"]:
            return out                  # every rank ran the whole batch
        return _tree_map(lambda t: _gather_rows(mesh, t), out)

    return run

"""Several cards and the synthesis + train-step programs
(``deepcharuco_tpu.parallel``): the ('data', 'spatial') mesh of
``torch.distributed`` ranks and the sharded programs (:mod:`.mesh`), and the
differentiable collectives they run on (:mod:`.collectives`)."""

from deepcharuco_tpu_torch.parallel.mesh import (
    Mesh,
    broadcast_spatial,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
    shard_frames,
    sharded_inference,
    sharded_synth_train_program,
    sharded_train_step,
    synth_scan_program,
)

__all__ = [
    "Mesh",
    "init_distributed",
    "make_mesh",
    "shard_batch",
    "shard_frames",
    "replicate",
    "sharded_train_step",
    "sharded_synth_train_program",
    "synth_scan_program",
    "sharded_inference",
    "broadcast_spatial",
]

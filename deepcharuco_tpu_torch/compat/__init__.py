"""Lightning ``.ckpt`` files ⇄ the JAX-layout weight tree (``compat.torch_convert``)."""

from deepcharuco_tpu_torch.compat.torch_convert import (
    detector_state_dict_from_variables,
    detector_variables_from_torch,
    load_lightning_checkpoint,
    refinenet_state_dict_from_variables,
    refinenet_variables_from_torch,
    save_lightning_checkpoint,
)

__all__ = [
    "detector_variables_from_torch",
    "refinenet_variables_from_torch",
    "load_lightning_checkpoint",
    "detector_state_dict_from_variables",
    "refinenet_state_dict_from_variables",
    "save_lightning_checkpoint",
]

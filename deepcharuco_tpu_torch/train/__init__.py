from deepcharuco_tpu_torch.train.steps import (
    TrainState,
    create_detector_state,
    create_refinenet_state,
    detector_loss_fn,
    flax_init_,
    make_detector_eval_step,
    make_detector_train_step,
    make_refinenet_eval_step,
    make_refinenet_train_step,
    refinenet_loss_fn,
    state_variables,
)

__all__ = [
    "TrainState",
    "create_detector_state",
    "create_refinenet_state",
    "detector_loss_fn",
    "flax_init_",
    "refinenet_loss_fn",
    "make_detector_train_step",
    "make_refinenet_train_step",
    "make_detector_eval_step",
    "make_refinenet_eval_step",
    "state_variables",
]

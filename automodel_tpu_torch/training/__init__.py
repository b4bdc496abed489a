from automodel_tpu_torch.training.train_step import (
    TrainState,
    TrainStepConfig,
    accumulate_grads,
    init_train_state,
    make_train_step,
)

__all__ = [
    "TrainState",
    "TrainStepConfig",
    "accumulate_grads",
    "init_train_state",
    "make_train_step",
]

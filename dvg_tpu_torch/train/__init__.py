"""Training of the port (counterpart of `dvg_tpu/train`): the three-pass
train step and its TrainState (`step.py`), the four Adam groups and the GP
schedule (`optim.py`); TrainState checkpoints are in
`dvg_tpu_torch/checkpoint.py`."""

from dvg_tpu_torch.train.optim import (MODULE_GROUPS, Optimizers,
                                       gp_lr_schedule, split_params)
from dvg_tpu_torch.train.step import (TrainState, init_train_state,
                                      make_train_step, train_state)

__all__ = ["MODULE_GROUPS", "Optimizers", "gp_lr_schedule",
           "split_params", "TrainState",
           "init_train_state", "make_train_step", "train_state"]

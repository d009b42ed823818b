"""AdamW and the training step (port of ``repro.train``)."""

from repro_torch.train.optimizer import (OptimizerConfig, OptState,
                                         apply_updates, global_norm,
                                         init_opt_state, lr_at)
from repro_torch.train.train_step import jitted_train_step, make_train_step

__all__ = ["OptimizerConfig", "OptState", "init_opt_state", "apply_updates",
           "lr_at", "global_norm", "make_train_step", "jitted_train_step"]

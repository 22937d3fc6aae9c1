"""LM training on one device or a mesh of ranks: the train config, AdamW,
the train step."""
from repro_torch.train.optimizer import (TrainConfig, adamw_update,
                                         init_opt_state, lr_at)
from repro_torch.train.steps import build_train_step

__all__ = ["TrainConfig", "init_opt_state", "adamw_update", "lr_at",
           "build_train_step"]

"""Training: AdamW, the train step and the fault-tolerant Trainer."""
from .optimizer import AdamWConfig, OptState, adamw_update, global_norm, init_opt_state, lr_at
from .step import TrainState, chunked_ce_loss, load_jax_train_state, make_train_state, make_train_step
from .trainer import Trainer, TrainerConfig

__all__ = ["AdamWConfig", "OptState", "adamw_update", "global_norm", "init_opt_state", "lr_at", "TrainState",
           "chunked_ce_loss", "load_jax_train_state", "make_train_state", "make_train_step", "Trainer", "TrainerConfig"]

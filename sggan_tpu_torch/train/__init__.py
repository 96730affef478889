from .pool import PoolDraws, PoolState, pool_draws, pool_init, pool_update
from .step import (AdamState, TrainState, build_step_fn, init_state,
                   lr_schedule, make_train_step)

__all__ = ["PoolDraws", "PoolState", "pool_draws", "pool_init",
           "pool_update", "AdamState", "TrainState", "build_step_fn",
           "init_state", "lr_schedule", "make_train_step"]

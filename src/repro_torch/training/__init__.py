"""Training (counterpart of the JAX package's ``training/``): AdamW with the
cosine, WSD and constant schedules, the unsharded train and eval steps, the
synthetic Markov LM, checkpoints in the JAX package's on-disk format, int8
gradient compression and pull-based microbatch dispatch.  The sharded step,
``elastic.py`` and ``compressed_psum`` wait for ROADMAP Queue 1 item 9."""

from .optimizer import OptConfig, OptState, adamw_update, global_norm, init_opt_state, schedule_lr
from .train_step import loss_and_grads, make_eval_step, make_train_step

__all__ = [
    "OptConfig",
    "OptState",
    "adamw_update",
    "global_norm",
    "init_opt_state",
    "loss_and_grads",
    "make_eval_step",
    "make_train_step",
    "schedule_lr",
]

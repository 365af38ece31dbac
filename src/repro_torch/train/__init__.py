"""Port of `repro/train`: AdamW with global-norm clipping and a cosine
schedule, and the train step (microbatch accumulation, int8-compressed
gradients) as autograd over the port's model."""
from repro_torch.train.optimizer import (
    AdamWState,
    adamw_init,
    adamw_update,
    cosine_lr,
)
from repro_torch.train.train_step import make_train_state, make_train_step

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_lr",
           "make_train_state", "make_train_step"]

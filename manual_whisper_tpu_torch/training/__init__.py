from .optim import (AdamW, AdamWState, adamw, warmup_cosine_decay_schedule)
from .train import (TrainState, features, init_train_state, loss_fn,
                    make_train_step)

__all__ = ["AdamW", "AdamWState", "adamw", "warmup_cosine_decay_schedule",
           "TrainState", "features", "init_train_state", "loss_fn",
           "make_train_step"]

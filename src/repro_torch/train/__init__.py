"""The training step (``loop``) and the serving loop (``serve``)."""
from .loop import (TrainConfig, init_state, make_grad_fn, make_loss_fn,
                   make_train_step, trainable)
from . import serve

"""Training graph (counterpart of ``smart_vocoder_tpu/training``): the GAN
train step and its optimizers."""

from smart_vocoder_torch.training.optim import lr_for_epoch, make_optimizer, set_learning_rate
from smart_vocoder_torch.training.step import (
    Batch,
    TrainState,
    init_train_state,
    make_train_step,
    nda_jigsaw,
)

__all__ = [
    "Batch",
    "TrainState",
    "init_train_state",
    "lr_for_epoch",
    "make_optimizer",
    "make_train_step",
    "nda_jigsaw",
    "set_learning_rate",
]

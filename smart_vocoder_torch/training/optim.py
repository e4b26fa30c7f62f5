"""Optimizers of the reference training recipe (train.py:88-120); counterpart
of ``smart_vocoder_tpu/training/optim.py``.

Two AdamW optimizers (G and D): lr 2e-4, betas (0.8, 0.99), eps 1e-9 from the
config, and torch AdamW's default weight decay 0.01 (the reference does not
override it). The learning rate decays once per *epoch* by ``lr_decay``
(ExponentialLR, train.py:109-110); the loop computes ``lr_for_epoch`` and
writes it with ``set_learning_rate``.

Under a model axis (``parallel/mesh.py``) each net's optimizer is a
``training.sharded.ShardedAdamW``: the same AdamW over this rank's share of
the parameters.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from smart_vocoder_torch.parallel.mesh import Mesh
from smart_vocoder_torch.training.sharded import ShardedAdamW

WEIGHT_DECAY = 0.01  # torch.optim.AdamW's default, used implicitly by train.py:88-97


def make_optimizer(hps, params: Iterable[torch.nn.Parameter],
                   mesh: Optional[Mesh] = None) -> torch.optim.AdamW:
    """AdamW over ``params``; over this rank's share of them where ``mesh``
    has a model axis."""
    kwargs = dict(lr=float(hps.train.learning_rate),
                  betas=(float(hps.train.betas[0]), float(hps.train.betas[1])),
                  eps=float(hps.train.eps), weight_decay=WEIGHT_DECAY)
    if mesh is not None and mesh.model > 1:
        return ShardedAdamW(params, mesh, **kwargs)
    return torch.optim.AdamW(params, **kwargs)


def lr_for_epoch(hps, epoch: int) -> float:
    """ExponentialLR with last_epoch=epoch-2 semantics: epoch 1 -> base lr
    (train.py:109-110, stepped once per epoch at train.py:119-120)."""
    return float(hps.train.learning_rate) * float(hps.train.lr_decay) ** (epoch - 1)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Write ``lr`` into every parameter group of ``opt``."""
    for group in opt.param_groups:
        group["lr"] = lr
    return opt

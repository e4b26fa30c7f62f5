"""The ``('data', 'model')`` mesh of the training ranks; counterpart of
``smart_vocoder_tpu/parallel/mesh.py``.

JAX lays its devices out as a ``data × model`` grid (``make_mesh``) and
places the whole ``TrainState`` by one shape rule (``_leaf_spec``): a leaf of
2 dims or more whose leading dim is at least 128 and divisible by the model
size is split along dim 0 over ``'model'``; every other leaf is replicated.
The port keeps the rule (``leaf_sharded``) and the grid over the ranks of the
process group: rank ``r`` sits at data index ``r // model`` and model index
``r % model``, so a model group is ``model`` consecutive ranks, neighbouring
cards as ``create_device_mesh`` lays them out.

What the port splits is the optimizer (``training/sharded.py``): each rank
of a model group keeps the AdamW moments of its dim-0 block of every leaf
the rule matches. The parameters stay whole on every rank between steps,
and the work is split by rows: each rank of a data group trains
``train.batch_size / model`` of that group's rows (``rows_per_rank``), so a
step trains ``train.batch_size × data`` rows, as JAX's does. One process is
``Mesh(1, 1)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from smart_vocoder_torch.parallel import dist as dist_lib


def leaf_sharded(shape: Sequence[int], model: int) -> bool:
    """JAX's ``_leaf_spec`` rule (``smart_vocoder_tpu/parallel/mesh.py:53-62``):
    whether a leaf of ``shape`` is split along dim 0 over a model axis of
    ``model`` ranks."""
    return model > 1 and len(shape) >= 2 and shape[0] >= 128 and shape[0] % model == 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``data × model`` grid of the process group's
    ranks, with its two groups: ``model_group`` (the ``model`` ranks that
    split one optimizer state between them) and ``data_group`` (the ranks
    that hold the same block). Both are ``None`` without a model axis."""

    data: int = 1
    model: int = 1
    rank: int = 0
    model_group: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @classmethod
    def build(cls, model: int = 1) -> "Mesh":
        """The mesh of the process group's ranks (one process: ``Mesh(1, 1)``)
        with a model axis of ``model`` ranks. Every rank must call it, with
        the same ``model``: every rank creates every group, in one order.
        Raises unless the world is a multiple of ``model``."""
        world, rank = dist_lib.world_size(), dist_lib.rank()
        if model < 1 or world % model:
            raise ValueError(f"tpu.model_parallel is {model}: the {world} ranks are not a "
                             "whole number of model groups")
        data = world // model
        if model == 1:
            return cls(data, 1, rank)
        model_group = data_group = None
        for d in range(data):
            group = dist.new_group(list(range(d * model, (d + 1) * model)))
            if d == rank // model:
                model_group = group
        for m in range(model):
            group = dist.new_group(list(range(m, world, model)))
            if m == rank % model:
                data_group = group
        return cls(data, model, rank, model_group, data_group)

    def rows_per_rank(self, batch_size: int) -> int:
        """The rows each rank trains of a data group's ``batch_size``."""
        if batch_size % self.model:
            raise ValueError(f"train.batch_size {batch_size} is not a multiple of "
                             f"tpu.model_parallel {self.model}: each rank of a model group "
                             "trains batch_size / model_parallel rows")
        return batch_size // self.model

    def block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's dim-0 block of ``t`` (a view: for a contiguous ``t`` a
        contiguous piece of its storage)."""
        rows = t.shape[0] // self.model
        return t.narrow(0, self.model_index * rows, rows)

    def __str__(self) -> str:
        return (f"data {self.data} x model {self.model} (rank {self.rank}: data index "
                f"{self.data_index}, model index {self.model_index})")

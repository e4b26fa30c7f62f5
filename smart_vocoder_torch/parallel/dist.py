"""Data parallelism through ``torch.distributed``: one process per card, in
place of the JAX package's ``('data', 'model')`` mesh (``parallel/mesh.py``;
the ``model`` axis is not ported).

A process started by ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` in its environment) joins the group in
``init_from_env``: NCCL on the card ``cuda:<LOCAL_RANK>``, gloo on the CPU.
Each rank loads ``train.batch_size`` rows of its own stripe of the sampler;
the train step averages the gradients of each phase with one flat all-reduce
before their norm and clamp, so every rank applies the global batch's
gradient, as JAX's ``pjit`` step does (``training/step.py``). The ranks
must resume one state: ``check_same`` stops them all where they do not.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from smart_vocoder_torch.utils.device import resolve_device


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def init_from_env(device=None) -> torch.device:
    """The device this process trains on. Under torchrun's environment it
    also joins the process group: NCCL on ``cuda:<LOCAL_RANK>``, gloo when
    ``device`` is the CPU. Without that environment nothing is joined."""
    device = resolve_device(device)
    if active() or not ("WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ):
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return device


def describe(device: torch.device) -> str:
    if not active():
        return f"one process on {device}"
    return (f"torch.distributed {dist.get_backend()}: rank {rank()} of {world_size()} "
            f"on {device}")


def shutdown() -> None:
    """Leave the group once every rank got here (the chief may still be saving)."""
    if active():
        dist.barrier()
        dist.destroy_process_group()


def check_same(what: str, values: Sequence[int], device) -> None:
    """Raise on every rank unless every rank passed the same integers: one
    all-reduce of their maxima and of their negated minima."""
    if not active():
        return
    mine = torch.tensor([int(v) for v in values], dtype=torch.int64, device=device)
    both = torch.cat([mine, -mine])
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    hi, lo = both[:len(mine)], -both[len(mine):]
    if not torch.equal(hi, lo):
        raise RuntimeError(
            f"the ranks disagree on {what}: from {lo.tolist()} to {hi.tolist()} (rank {rank()}: "
            f"{mine.tolist()}); every rank must read the chief's checkpoints from one directory")


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the ranks (a copy; ``t`` itself where there is one)."""
    if not active():
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t


def average_gradients(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the ranks of each gradient, by one all-reduce of all of
    them flattened into one buffer."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= world_size()
    return [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]), grads)]


def mean_scalars(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The 0-d tensors of ``metrics`` averaged over the ranks, as floats read
    to the host in one copy."""
    names = [k for k, v in metrics.items() if v.ndim == 0]
    stacked = torch.stack([metrics[k].float() for k in names])
    if active():
        dist.all_reduce(stacked)
        stacked /= world_size()
    return dict(zip(names, stacked.tolist()))

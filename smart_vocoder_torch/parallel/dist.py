"""Data parallelism through ``torch.distributed``: one process per card, in
place of the JAX package's ``('data', 'model')`` mesh (``parallel/mesh.py``
lays the ranks out on that grid and splits the optimizer state over its
``model`` axis; ``training/sharded.py``).

How many ranks: ``tpu.data_parallel × tpu.model_parallel``, as JAX's
``make_mesh(data=..., model=...)`` reads them (``ranks_to_start``):
``data_parallel: -1`` is every visible card over ``model_parallel``.
Without torchrun the ``train`` CLI starts them itself (``start_ranks``);
under torchrun the count is torchrun's and the config must agree with it.
A process started either way (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` in its environment) joins the group in
``init_from_env``: NCCL on the card ``cuda:<LOCAL_RANK>``, gloo on the CPU.
Each rank loads ``train.batch_size / model_parallel`` rows of its own stripe
of the sampler; the train step averages the gradients of each phase with
one flat all-reduce over every rank before their norm and clamp, so every
rank applies the global batch's gradient, as JAX's ``pjit`` step does
(``training/step.py``). The ranks must resume one state: ``check_same``
stops them all where they do not.
"""

from __future__ import annotations

import os
import socket
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from smart_vocoder_torch.utils.device import resolve_device


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def torchrun_world() -> Optional[int]:
    """``WORLD_SIZE`` where torchrun's environment is set, else ``None``."""
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return None


def ranks_to_start(data_parallel: int, cards: int, world: Optional[int] = None,
                   cpu: bool = False, model_parallel: int = 1) -> int:
    """How many ranks the ``train`` CLI starts for a mesh of
    ``tpu.data_parallel × tpu.model_parallel``, with ``cards`` visible
    cards, under torchrun's ``world`` ranks (or ``None``), on the CPU or
    not. 1 means this process trains (and, under torchrun, joins its group).
    ``data_parallel: -1`` is every visible card over ``model_parallel``
    (``make_mesh``'s ``n // model``; one data index on the CPU, and one
    process where there is no card: the device rule then raises); ``N`` is
    ``N × model_parallel`` ranks (gloo ranks on the CPU). Raises for more
    ranks than cards, and under torchrun for a mesh of other than ``world``
    ranks."""
    if data_parallel == 0 or data_parallel < -1:
        raise ValueError(f"tpu.data_parallel is {data_parallel}: -1 (every card) or N >= 1")
    if model_parallel < 1:
        raise ValueError(f"tpu.model_parallel is {model_parallel}: N >= 1")
    if world is not None:
        if world % model_parallel:
            raise ValueError(f"tpu.model_parallel is {model_parallel} under torchrun's {world} "
                             "ranks: start a multiple of it")
        if data_parallel not in (-1, world // model_parallel):
            raise ValueError(f"tpu.data_parallel is {data_parallel} under torchrun's {world} "
                             f"ranks at tpu.model_parallel {model_parallel}: set it to -1 or "
                             f"{world // model_parallel}")
        return 1
    if data_parallel == -1:
        if cpu:
            data_parallel = 1
        elif cards == 0:
            return 1
        elif cards % model_parallel:  # make_mesh asserts the same
            raise ValueError(f"tpu.data_parallel is -1 at tpu.model_parallel {model_parallel}, "
                             f"and {cards} CUDA cards are visible: not a multiple of it")
        else:
            data_parallel = cards // model_parallel
    n = data_parallel * model_parallel
    if n > 1 and not cpu and n > cards:
        raise ValueError(f"tpu.data_parallel x tpu.model_parallel is {data_parallel} x "
                         f"{model_parallel} = {n}, and {cards} CUDA cards are visible")
    return n


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, world: int, port: int, fn: Callable, args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    fn(*args)


def start_ranks(n: int, fn: Callable, args: tuple) -> None:
    """Run ``fn(*args)`` in ``n`` spawned processes with torchrun's variables
    set for one host (rank = local rank, a free port), as the reference's
    ``mp.spawn`` did; returns when all have ended, and raises where one
    failed (the others are then stopped)."""
    mp.start_processes(_rank_entry, args=(n, free_port(), fn, args), nprocs=n, join=True,
                       start_method="spawn")


def init_from_env(device=None) -> torch.device:
    """The device this process trains on. Under torchrun's environment it
    also joins the process group: NCCL on ``cuda:<LOCAL_RANK>``, gloo when
    ``device`` is the CPU. Without that environment nothing is joined."""
    device = resolve_device(device)
    if active() or torchrun_world() is None:
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

"""Training entry point, the port's counterpart of the repo's ``train.py``:

    python -m smart_vocoder_torch.train -c configs/iitp_base.json -m iitp \
        [--max-steps N] [--device cpu]

Creates ``./logs/<model>/``, copies the config there as ``config.json``,
resumes from the newest ``G_``/``D_`` checkpoint pair in it if there is one,
and trains (``training.loop.run``). It runs on the CUDA card unless
``--device cpu`` is given. Over cards, as JAX's loop builds its mesh from
``tpu.data_parallel`` and ``tpu.model_parallel``: one rank a card,
``data_parallel × model_parallel`` of them, where ``data_parallel: -1`` (the
default) is every visible card over ``model_parallel``; with ``--device
cpu`` they are gloo ranks, and ``-1`` is one data index. Under ``torchrun
--nproc_per_node N -m smart_vocoder_torch.train ...`` torchrun starts the
ranks instead, and ``N`` must be ``data_parallel × model_parallel`` (a
multiple of ``model_parallel`` at ``-1``). Each rank joins the group (NCCL
on its card, gloo on the CPU) and trains ``train.batch_size /
model_parallel`` rows of every step; the ranks of a model group split the
optimizer state between them (``parallel/mesh.py``). A rank that fails makes
the command fail.
"""

from __future__ import annotations

import argparse
import sys

import torch

from smart_vocoder_torch.config import get_hparams
from smart_vocoder_torch.parallel import dist as dist_lib
from smart_vocoder_torch.training.loop import run


def train_rank(hps, max_steps, device) -> None:
    """One rank, or the only process: join the group if there is one, train."""
    device = dist_lib.init_from_env(device)
    run(hps, max_steps=max_steps, device=device)
    dist_lib.shutdown()  # after every rank's last step (a failed rank exits without it)


def main(argv=None) -> None:
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--max-steps", type=int, default=None,
                       help="stop after N global steps (smoke runs, benchmarks)")
    extra.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ns, rest = extra.parse_known_args(sys.argv[1:] if argv is None else argv)
    hps = get_hparams(rest)
    cpu = ns.device is not None and torch.device(ns.device).type == "cpu"
    n = dist_lib.ranks_to_start(int(hps.tpu.get("data_parallel", -1)),
                                torch.cuda.device_count(), dist_lib.torchrun_world(), cpu,
                                int(hps.tpu.get("model_parallel", 1)))
    if n == 1:
        train_rank(hps, ns.max_steps, ns.device)
    else:
        dist_lib.start_ranks(n, train_rank, (hps, ns.max_steps, ns.device))


if __name__ == "__main__":
    main()

"""Training entry point, the port's counterpart of the repo's ``train.py``:

    python -m smart_vocoder_torch.train -c configs/iitp_base.json -m iitp \
        [--max-steps N] [--device cpu]

Creates ``./logs/<model>/``, copies the config there as ``config.json``,
resumes from the newest ``G_``/``D_`` checkpoint pair in it if there is one,
and trains (``training.loop.run``). It runs on the CUDA card unless
``--device cpu`` is given. Data parallel over cards: start it under
``torchrun --nproc_per_node N -m smart_vocoder_torch.train ...``; each
process joins the group from torchrun's environment (NCCL on its card, gloo
with ``--device cpu``) and trains ``train.batch_size`` rows of every step.
"""

from __future__ import annotations

import argparse
import sys

from smart_vocoder_torch.config import get_hparams
from smart_vocoder_torch.parallel import dist as dist_lib
from smart_vocoder_torch.training.loop import run


def main(argv=None) -> None:
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--max-steps", type=int, default=None,
                       help="stop after N global steps (smoke runs, benchmarks)")
    extra.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ns, rest = extra.parse_known_args(sys.argv[1:] if argv is None else argv)
    hps = get_hparams(rest)
    device = dist_lib.init_from_env(ns.device)
    run(hps, max_steps=ns.max_steps, device=device)
    dist_lib.shutdown()  # after every rank's last step (a failed rank exits without it)


if __name__ == "__main__":
    main()

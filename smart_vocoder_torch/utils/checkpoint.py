"""Checkpoints and resume for the training loop; counterpart of
``smart_vocoder_tpu/utils/checkpoint.py``.

The resumable checkpoint is the pair ``G_<step>.pth`` / ``D_<step>.pth`` in
the model directory, each a reference-format payload
(``utils.torch_compat.save_torch_checkpoint``): the net's f32 weights, its
AdamW state, ``iteration`` (the steps the state has taken), the learning
rate and the epoch that was running. (The JAX package resumes from orbax and
mirrors ``.pth`` files with an empty optimizer; the port has no orbax.)

``<step>`` is the loop's label, as the JAX loop's: a save at an eval step
``s`` holds the state after step ``s`` ran, ``s + 1`` steps in all; the save
at the end of a run holds ``s`` steps. Resume reads the steps from
``iteration``.

Under a model axis (``parallel/mesh.py``) each rank keeps the AdamW moments
of its share of the parameters, and the pair still holds the full state:
every rank of the writer's model group calls ``save``, whose optimizer state
dicts gather the moments over the group (``training/sharded.py``), and only
the writer writes. ``restore`` reads the full pair on every rank, and each
keeps its own share, so a pair resumes at any mesh, one process included.
"""

from __future__ import annotations

import logging
import os
import re
from typing import List, Optional, Tuple

import torch

from smart_vocoder_torch.utils.torch_compat import load_torch_checkpoint, save_torch_checkpoint

_NAME = re.compile(r"^([GD])_(\d+)\.pth$")


class CheckpointManager:
    """``G_<step>.pth`` / ``D_<step>.pth`` pairs in ``model_dir``, the newest
    ``keep`` of them kept (all when ``keep <= 0``)."""

    def __init__(self, model_dir: str, keep: int = 5):
        self.directory = os.path.abspath(model_dir)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = int(keep)

    def path(self, tag: str, step: int) -> str:
        return os.path.join(self.directory, f"{tag}_{step}.pth")

    def _files(self) -> dict:
        found: dict = {"G": set(), "D": set()}
        for name in os.listdir(self.directory):
            m = _NAME.match(name)
            if m:
                found[m.group(1)].add(int(m.group(2)))
        return found

    def steps(self) -> List[int]:
        """Steps for which both files exist, oldest first."""
        found = self._files()
        return sorted(found["G"] & found["D"])

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, epoch: int, learning_rate: float,
             write: bool = True) -> None:
        """Write the pair for ``step``; then, with both files in place, remove
        the pairs (and stray single files) older than the newest ``keep``.
        Both optimizers' state dicts are taken before anything is written;
        under a model axis that is a collective of the model group, whose
        other ranks call this with ``write=False`` and write nothing."""
        optimizers = {"G": state.opt_g.state_dict(), "D": state.opt_d.state_dict()}
        if not write:
            return
        for tag, net in (("G", state.net_g), ("D", state.net_d)):
            save_torch_checkpoint(self.path(tag, step), net, optimizers[tag], state.step,
                                  learning_rate, epoch)
        if self.keep > 0:
            kept = set(self.steps()[-self.keep:])
            for tag, steps in self._files().items():
                for s in steps:
                    if s not in kept and s < max(kept):
                        os.remove(self.path(tag, s))

    def restore(self, state, step: Optional[int] = None) -> Tuple[object, int, int]:
        """Load the pair for ``step`` (the latest by default) into ``state``:
        both nets, both optimizers and the step count. Returns (state, epoch,
        step). Both payloads are read and checked against ``state`` before
        anything in it changes, so a failure leaves ``state`` as it was."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no G_/D_ checkpoint pair under {self.directory}")
        payloads = {tag: load_torch_checkpoint(self.path(tag, step)) for tag in ("G", "D")}
        nets = {"G": (state.net_g, state.opt_g), "D": (state.net_d, state.opt_d)}
        for tag, (net, opt) in nets.items():
            own, got = net.state_dict(), payloads[tag]["model"]
            if set(own) != set(got):
                raise KeyError(f"{tag}_{step}.pth: keys differ from the model's: "
                               f"{sorted(set(own) ^ set(got))[:5]}")
            bad = [k for k in own if own[k].shape != got[k].shape]
            if bad:
                raise ValueError(f"{tag}_{step}.pth: shapes differ at {bad[:5]}")
            groups = payloads[tag]["optimizer"]["param_groups"]
            if [len(g["params"]) for g in groups] != [len(g["params"]) for g in opt.param_groups]:
                raise ValueError(f"{tag}_{step}.pth: the optimizer's parameter groups differ")
        if payloads["G"]["iteration"] != payloads["D"]["iteration"]:
            raise ValueError(f"G_{step}.pth and D_{step}.pth hold different iterations")
        with torch.no_grad():
            for tag, (net, opt) in nets.items():
                net.load_state_dict(payloads[tag]["model"], strict=True)
                opt.load_state_dict(payloads[tag]["optimizer"])
        state.step = int(payloads["G"]["iteration"])
        return state, int(payloads["G"].get("epoch", 1)), int(step)


def try_resume(mngr: CheckpointManager, state):
    """Resume from the latest pair, else start fresh (train.py:101-107).

    Returns (state, epoch_in_progress, resumed). The epoch is the one that was
    running at the save, which the loop re-enters, skipping the batches that
    were consumed. No checkpoint is the normal fresh start and stays silent; a
    latest pair that fails to load logs a WARNING, then starts fresh."""
    if mngr.latest_step() is None:
        return state, 1, False
    try:
        state, epoch, _ = mngr.restore(state)
        return state, max(1, epoch), True
    except Exception as e:  # noqa: BLE001 -- any unreadable checkpoint: fresh start, said loudly
        logging.getLogger("smart_vocoder_torch").warning(
            "resume failed from %s (latest step %s): %s: %s -- starting fresh at step 0",
            mngr.directory, mngr.latest_step(), type(e).__name__, e)
        return state, 1, False

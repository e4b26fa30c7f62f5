"""Weights carried into the port: from the JAX package's parameter tree, or
from a reference ``G_*.pth``.

The JAX package stores every conv in the torch layout, so the bridge is pure
*name* mapping (``smart_vocoder_tpu/utils/torch_compat.py:path_to_torch_key``,
reimplemented here without flax):

  ('enc_q', 'enc', 'in_layers_3', 'weight_v')  ->  enc_q.enc.in_layers.3.weight_v
  ('emb_g', 'embedding')                       ->  emb_g.weight
  ('discriminators_1', 'convs_0', 'weight_v')  ->  discriminators.1.convs.0.weight_v

The discriminator's spectral-norm state (the JAX ``spectral`` collection,
``weight_u`` leaves) maps the same way onto the port's ``weight_u`` buffers.

The trainer's own checkpoints are reference-format payloads too
(``save_torch_checkpoint``): the f32 master weights under the reference
names, with the optimizer's real state beside them.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def path_to_torch_key(path: Tuple[str, ...]) -> str:
    """``('dec', 'resblocks_7', 'convs1_2', 'weight_v')`` ->
    ``dec.resblocks.7.convs1.2.weight_v``."""
    parts: list[str] = []
    for p in path:
        head, _, tail = p.rpartition("_")
        if head and tail.isdigit():
            parts.extend([head, tail])
        else:
            parts.append(p)
    key = ".".join(parts)
    return "emb_g.weight" if key == "emb_g.embedding" else key


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of numpy arrays) -> flat torch
    ``state_dict`` (float32 tensors, layouts unchanged)."""
    return {path_to_torch_key(path): torch.from_numpy(np.array(v, np.float32))
            for path, v in _flatten(params)}


def discriminator_state_dict_from_jax(params: Mapping[str, Any],
                                      spectral: Mapping[str, Any] | None = None
                                      ) -> Dict[str, torch.Tensor]:
    """A JAX discriminator's ``params`` and, under spectral norm, its
    ``spectral`` collection -> one flat torch ``state_dict`` (parameters and
    ``weight_u`` buffers) for ``MultiPeriodDiscriminator.load_state_dict``."""
    return {**state_dict_from_jax_params(params), **state_dict_from_jax_params(spectral or {})}


def _ignorable(key: str) -> bool:
    # Reference checkpoints carry cond_layer / cond params (gin_channels=256 is
    # plumbed everywhere) that only a speaker-conditioned model has.
    return any(p == "cond_layer" or p == "cond" for p in key.split("."))


def load_torch_checkpoint(pth_path: str) -> Dict[str, Any]:
    """A ``.pth`` payload ``{model, iteration, optimizer, learning_rate, ...}``
    (ref: utils.py:46-56), its tensors on the CPU."""
    return torch.load(pth_path, map_location="cpu", weights_only=False)


def load_reference_generator(pth_path: str, net: torch.nn.Module) -> int:
    """Load a reference ``G_<step>.pth`` payload ``{model, iteration, ...}``
    (ref: utils.py:46-56) into ``net`` strictly, dropping the conditioning
    keys an unconditioned model lacks. Returns the iteration."""
    payload = load_torch_checkpoint(pth_path)
    own = net.state_dict()
    sd = {k: v for k, v in payload["model"].items() if k in own or not _ignorable(k)}
    net.load_state_dict(sd, strict=True)
    return int(payload.get("iteration", 0))


def load_reference_discriminator(pth_path: str, net: torch.nn.Module) -> int:
    """Load a ``D_<step>.pth`` payload into ``net`` strictly (parameters and,
    under spectral norm, the ``weight_u`` buffers). Returns the iteration."""
    payload = load_torch_checkpoint(pth_path)
    net.load_state_dict(payload["model"], strict=True)
    return int(payload.get("iteration", 0))


def save_torch_checkpoint(path: str, net: torch.nn.Module, optimizer_state: Dict[str, Any],
                          iteration: int, learning_rate: float, epoch: int) -> None:
    """Write ``{model, iteration, optimizer, learning_rate, epoch}``: the
    reference payload (utils.py:46-56) plus the epoch. ``model`` is ``net``'s
    state dict (the f32 master weights: ``weight_g`` / ``weight_v``, under
    spectral norm ``weight_orig`` / ``weight_u``), ``optimizer`` the
    optimizer's state dict as its ``state_dict()`` gives it (full-shaped
    under a model axis too: ``training/sharded.py``). Written to a temporary
    name beside ``path`` and moved into place, so a reader never sees half a
    file."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"model": net.state_dict(), "iteration": int(iteration),
                "optimizer": optimizer_state, "learning_rate": float(learning_rate),
                "epoch": int(epoch)}, tmp)
    os.replace(tmp, path)

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
"""

from __future__ import annotations

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


def load_reference_generator(pth_path: str, net: torch.nn.Module) -> int:
    """Load a reference ``G_<step>.pth`` payload ``{model, iteration, ...}``
    (ref: utils.py:46-56) into ``net`` strictly, dropping the conditioning
    keys an unconditioned model lacks. Returns the iteration."""
    payload = torch.load(pth_path, map_location="cpu", weights_only=False)
    own = net.state_dict()
    sd = {k: v for k, v in payload["model"].items() if k in own or not _ignorable(k)}
    net.load_state_dict(sd, strict=True)
    return int(payload.get("iteration", 0))

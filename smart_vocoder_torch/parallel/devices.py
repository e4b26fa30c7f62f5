"""The devices of the data axis and the rows each one decodes.

Counterpart of ``smart_vocoder_tpu/parallel/mesh.py:make_mesh`` and
``batch_sharding`` for the ``'data'`` axis only (JAX's ``Vocoder(mesh=...)``
passes the parameters replicated, so a ``'model'`` axis there would decode
the same rows on each of its devices; training's is ``parallel/mesh.py``):
``data_devices`` picks the cards a ``Vocoder(devices=...)`` splits a
batch over, and ``split_rows`` cuts the batch into one block of rows each.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def data_devices(n: int = -1, device: str | torch.device | None = None) -> List[torch.device]:
    """The first ``n`` visible cards, or all of them for ``n = -1``; raises
    where fewer exist (``make_mesh`` asserts the same). With
    ``device="cpu"``, ``n`` CPU shards, and one for ``-1``."""
    if n == 0 or n < -1:
        raise ValueError(f"the data axis needs one device or more, got {n}")
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * (1 if n == -1 else n)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == -1:
        n = cards
    if cards == 0 or n > cards:
        raise RuntimeError(f"the data axis needs {max(n, 1)} CUDA cards, {cards} visible; "
                           'pass device="cpu" to run on the CPU')
    return [torch.device("cuda", i) for i in range(n)]


def check_devices(devices: Sequence[str | torch.device]) -> List[torch.device]:
    """``devices`` as ``torch.device`` objects, each card with its index;
    raises for an empty list and for a card that is not there."""
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("devices= is empty: name one device per shard")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for i, d in enumerate(out):
        if d.type != "cuda":
            continue
        if d.index is None and cards:
            d = torch.device("cuda", torch.cuda.current_device())
        if d.index is None or d.index >= cards:
            raise RuntimeError(f"no CUDA device {d}: {cards} visible; "
                               'pass device="cpu" to run on the CPU')
        out[i] = d
    return out


def split_rows(b: int, shards: int) -> List[slice]:
    """``shards`` contiguous blocks of the rows ``0 .. b - 1``, in order,
    whose sizes differ by at most one (the first ``b % shards`` blocks take
    the extra row); a block is empty where ``b < shards``.

    JAX pads a batch to a multiple of the axis, because ``shard_map`` needs
    equal shards, and drops the padded rows' audio. No operation mixes the
    rows of a batch and the prior noise of a row is keyed by its global
    index, so the audio of each real row is the same either way; the port
    decodes no padded rows."""
    if shards < 1:
        raise ValueError(f"split_rows: {shards} shards")
    size, extra = divmod(b, shards)
    blocks, lo = [], 0
    for i in range(shards):
        hi = lo + size + (i < extra)
        blocks.append(slice(lo, hi))
        lo = hi
    return blocks

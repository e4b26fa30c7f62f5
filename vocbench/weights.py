"""Seeded weights, made on the device in a few large calls.

The rule is the models' own initialiser (the program's ``utils/init.py`` and
torch's conv default): every conv weight and bias uniform in
``±1/sqrt(fan_in)``, a speaker embedding standard normal, ``conv_post``'s
weight times ``conv_post_gain`` (30 for serving, which lifts a fresh
generator's output to speech-like levels; 1 for training). Unlike the
program's trainer init, the couplings' ``post`` convolutions are drawn too
and not zeroed, so the flow does work from the first call.

All uniform numbers come from one ``torch.rand`` call on the device's
generator, the normals from one ``torch.randn``; each leaf is a slice. The
benchmark hands the same dict to the program and to the reference.
"""

from __future__ import annotations

import math

import torch

from vocbench.reference.graph import Param


def make(params: list[Param], seed: int, device, conv_post_gain: float = 30.0,
         weight_norm: frozenset = frozenset()) -> dict[str, torch.Tensor]:
    """Leaves of ``params`` from ``seed`` on ``device`` (float32). A weight
    whose module is in ``weight_norm`` is given as ``weight_v`` (the drawn
    tensor) and ``weight_g`` (its norm over every dim but 0), as torch's
    weight-norm wrapper starts it; the folded weight is the drawn tensor."""
    gen = torch.Generator(device=device).manual_seed(seed)
    uniform = [q for q in params if q.kind != "embedding"]
    normal = [q for q in params if q.kind == "embedding"]
    flat_u = torch.rand(sum(math.prod(q.shape) for q in uniform), generator=gen,
                        device=device).mul_(2).sub_(1)
    flat_n = torch.randn(sum(math.prod(q.shape) for q in normal) or 1, generator=gen,
                         device=device)
    out: dict[str, torch.Tensor] = {}
    off = 0
    for q in uniform:
        n = math.prod(q.shape)
        w = flat_u[off: off + n].view(q.shape).mul(1.0 / math.sqrt(q.fan_in))
        off += n
        module = q.name.rsplit(".", 1)[0]
        if q.name == "dec.conv_post.weight":
            w = w * conv_post_gain
        if q.kind == "weight" and module in weight_norm:
            out[f"{module}.weight_v"] = w
            out[f"{module}.weight_g"] = torch.sqrt((w * w).sum(dim=tuple(range(1, w.ndim)),
                                                             keepdim=True))
        else:
            out[q.name] = w
    off = 0
    for q in normal:
        n = math.prod(q.shape)
        out[q.name] = flat_n[off: off + n].view(q.shape).clone()
        off += n
    return out

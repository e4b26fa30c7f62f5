"""The prior noise the program derives from a seed, worked out again: frozen
copies of the program's two rules, so the reference sees the same latents
without reading anything the program made.

- ``batch_eps``: ``Vocoder.mel_to_wav``'s noise. Row ``i`` of a call seeded
  ``seed`` is ``torch.randn((t, c))`` from a CPU generator seeded by
  ``numpy.random.SeedSequence([seed, i])``'s first 64-bit word.
- ``positional_eps``: the live windows' noise. Frame ``t`` of a stream seeded
  ``s`` is Philox-4x32-10 (Salmon et al., SC 2011) keyed by the 64-bit seed,
  counter ``(t mod 2^32, t div 2^32, channel // 4, 0)``, its four words two
  Box-Muller pairs in float64, rounded once to float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
MASK32 = 0xFFFFFFFF


def batch_eps(seed: int, b: int, t: int, channels: int) -> torch.Tensor:
    """(b, t, channels) float32 on the CPU."""
    rows = []
    for i in range(b):
        s = int(np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0])
        rows.append(torch.randn((t, channels), generator=torch.Generator().manual_seed(s)))
    return torch.stack(rows)


def _mulhilo(a: int, b: torch.Tensor):
    p0 = a * (b & 0xFFFF)
    p1 = a * (b >> 16)
    s = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (s >> 32), s & MASK32


def _philox(c0, c1, c2, c3, k0, k1):
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & MASK32
            k1 = (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _box_muller(u, v):
    scale = 2.0 ** -32
    r = torch.sqrt(-2.0 * torch.log((u.double() + 0.5) * scale))
    theta = (2.0 * math.pi * scale) * (v.double() + 0.5)
    return r * torch.cos(theta), r * torch.sin(theta)


def positional_eps(seeds, starts, n: int, channels: int, device="cpu") -> torch.Tensor:
    """(N, n, channels) float32: row r, frame j from (seeds[r], starts[r] + j).
    A seed is read as its 64 low bits, two's complement for a negative one."""
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=device).reshape(-1, 1, 1)
    starts = torch.as_tensor(starts, dtype=torch.int64, device=device).reshape(-1, 1, 1)
    blocks = (channels + 3) // 4
    frame = starts + torch.arange(n, dtype=torch.int64, device=device)[None, :, None]
    block = torch.arange(blocks, dtype=torch.int64, device=device)[None, None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    w = _philox(frame & MASK32, (frame >> 32) & MASK32, block, zero,
                seeds & MASK32, (seeds >> 32) & MASK32)
    z0, z1 = _box_muller(w[0], w[1])
    z2, z3 = _box_muller(w[2], w[3])
    eps = torch.stack([z0, z1, z2, z3], dim=-1).reshape(seeds.shape[0], n, 4 * blocks)
    return eps[..., :channels].float()

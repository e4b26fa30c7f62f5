"""Position-keyed prior noise: frame ``t`` of a stream seeded ``s`` draws the
same ``inter_channels`` normals whichever window, batch row or co-scheduled
stream asks for it.

Counterpart of ``_positional_eps`` / ``_positional_eps_graph``
(``smart_vocoder_tpu/inference.py:145-160``, ``:358-377``), which draw
``normal(fold_in(key(seed), frame))`` from threefry. Torch has no threefry, so
the stream here is the port's own: Philox-4x32-10 (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC 2011) keyed by the 64-bit seed, with
the counter ``(frame mod 2^32, frame div 2^32, channel // 4, 0)``; its four
32-bit words give the normals of channels ``4j .. 4j + 3`` by Box-Muller,
words 0-1 and 2-3 a pair each. The JAX and the port streams differ, so audio
is compared across the two only with the noise passed in.

The integer part runs in int64 tensor ops on the caller's device, and every
intermediate stays below 2^49: torch has no unsigned 64-bit multiply-high, so
each 32 x 32-bit product is taken in two halves of the second factor. The
integers are the same on every device; the transform to normals runs in
float64 and rounds once to float32, so devices can differ there only where
their float64 ``log``/``cos``/``sin`` differ by an ulp across a float32
rounding boundary.
"""

from __future__ import annotations

import math

import torch

PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # key schedule (golden ratio, sqrt(3) - 1)
PHILOX_ROUNDS = 10
MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``a * b`` for a 32-bit constant ``a`` and
    a tensor of 32-bit values ``b`` (int64): ``a * (b mod 2^16)`` and ``a *
    (b div 2^16)`` are each below 2^48."""
    p0 = a * (b & 0xFFFF)
    p1 = a * (b >> 16)
    s = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (s >> 32), s & MASK32


def philox4x32(counter: list[torch.Tensor], key: list[torch.Tensor]) -> list[torch.Tensor]:
    """Philox-4x32-10 on broadcastable int64 tensors of 32-bit words: four
    counter words and two key words in, four words out."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W[0]) & MASK32
            k1 = (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def _box_muller(u: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two 32-bit words -> two standard normals (float64). The words map to
    ``(w + 0.5) / 2^32``, strictly inside (0, 1), so the log is finite."""
    scale = 2.0 ** -32
    r = torch.sqrt(-2.0 * torch.log((u.double() + 0.5) * scale))
    theta = (2.0 * math.pi * scale) * (v.double() + 0.5)
    return r * torch.cos(theta), r * torch.sin(theta)


def positional_eps(seeds, starts, n: int, channels: int,
                   device: str | torch.device | None = None) -> torch.Tensor:
    """Prior noise ``(N, n, channels)`` float32: row ``r``, frame ``t`` is a
    pure function of ``(seeds[r], starts[r] + t)`` and the channel.

    ``seeds`` and ``starts`` are ``(N,)`` integer sequences or tensors (a seed
    is read as its 64 low bits, two's complement for a negative one; a frame
    index must be non-negative). The tensors are made on ``device`` (default:
    that of ``seeds`` if it is a tensor, else the CPU)."""
    if device is None:
        device = seeds.device if isinstance(seeds, torch.Tensor) else "cpu"
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=device).reshape(-1, 1, 1)
    starts = torch.as_tensor(starts, dtype=torch.int64, device=device).reshape(-1, 1, 1)
    if seeds.shape != starts.shape:
        raise ValueError(f"seeds {tuple(seeds.shape)} and starts {tuple(starts.shape)} differ")
    blocks = (channels + 3) // 4
    frame = starts + torch.arange(n, dtype=torch.int64, device=device)[None, :, None]
    block = torch.arange(blocks, dtype=torch.int64, device=device)[None, None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    w = philox4x32([frame & MASK32, (frame >> 32) & MASK32, block, zero],
                   [seeds & MASK32, (seeds >> 32) & MASK32])
    z0, z1 = _box_muller(w[0], w[1])
    z2, z3 = _box_muller(w[2], w[3])
    eps = torch.stack([z0, z1, z2, z3], dim=-1).reshape(seeds.shape[0], n, 4 * blocks)
    return eps[..., :channels].float()


def prior_sample(m_p: torch.Tensor, logs_p: torch.Tensor, eps: torch.Tensor,
                 noise_scale) -> torch.Tensor:
    """``z_p = m_p + eps * exp(logs_p) * s`` in ``m_p.dtype``, ``eps`` laid
    out as ``m_p``.

    ``noise_scale`` is a Python float or a per-row ``(B,)`` tensor. Either is
    rounded to ``m_p.dtype`` before the product, as JAX rounds a weak-typed
    scalar against a bf16 array (``smart_vocoder_tpu/models/synthesizer.py:
    328``), so a float and a tensor of the same values give the same bits.
    Both go through float32 first, so a float rounds once to float32 then to
    ``m_p.dtype``, as a float32 tensor of it does. A float becomes a tensor by
    a fill on ``m_p``'s device, not a copy from the host, so a CUDA graph can
    hold it (``programs.ServingProgram``)."""
    if isinstance(noise_scale, (int, float)):
        scale = torch.full((), float(noise_scale), dtype=torch.float32, device=m_p.device)
    else:
        scale = torch.as_tensor(noise_scale, dtype=torch.float32, device=m_p.device)
    scale = scale.to(m_p.dtype)
    if scale.ndim:  # one scale per row
        scale = scale.reshape((-1,) + (1,) * (m_p.ndim - 1))
    return m_p + eps.to(m_p.dtype) * torch.exp(logs_p) * scale

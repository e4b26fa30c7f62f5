"""Fused add-tanh-sigmoid gate: a Triton kernel and its plain version.

:func:`fused_gate` replaces ``smart_vocoder_tpu/kernels/gate.py:fused_gate``:
``tanh(x[..., :H] + g[..., :H]) * sigmoid(x[..., H:] + g[..., H:])`` over
``x (..., 2H)`` with ``g`` absent or broadcastable to ``x`` (the conditioned WN
gives ``(B, 1, 2H)``), out ``(..., H)`` in ``x.dtype``. As in the JAX package,
no module calls it (``nn/wn.py`` uses the plain gate), and it has no backward.

Why Triton and not CUDA C++: the gate is one elementwise pass over x and a
broadcast g -- no reuse, no reduction across threads, ~10 operations for the
6 bytes per output it moves in bf16 -- so it is bound by memory traffic, and
Triton's generated loads and stores reach that bound as well as hand-written
ones would. ``g`` is read through its broadcast strides, not materialised at
x's shape as the TPU wrapper does. The kernel computes in f32 and rounds once
to ``x.dtype``.

For a CUDA tensor :func:`fused_gate` launches the kernel or raises; for a CPU
tensor it runs :func:`fused_gate_plain`, which the tests and ``chip_smoke.py``
hold the kernel against.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from smart_vocoder_torch.kernels._build import count_launches

BLOCK = 1024  # outputs per program


def fused_gate_plain(x: torch.Tensor, g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`fused_gate`: f32 arithmetic, one rounding."""
    h = x.shape[-1] // 2
    act = x.float() if g is None else x.float() + g.to(x.dtype).float()
    return (torch.tanh(act[..., :h]) * torch.sigmoid(act[..., h:])).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _gate_kernel():
    """The Triton kernel, built at first use (``triton`` exists only where
    there is a card, so it is imported here and not with the module)."""
    import triton
    import triton.language as tl

    @triton.jit
    def gate_kernel(x_ptr, g_ptr, out_ptr, n_out, H, T, g_sb, g_st, g_sc,
                    HAS_G: tl.constexpr, BLOCK: tl.constexpr):
        idx = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        live = idx < n_out
        row = idx // H
        col = idx - row * H
        xa = x_ptr + row * (2 * H) + col
        a = tl.load(xa, mask=live, other=0.0).to(tl.float32)
        b = tl.load(xa + H, mask=live, other=0.0).to(tl.float32)
        if HAS_G:
            bi = row // T
            ga = g_ptr + bi * g_sb + (row - bi * T) * g_st + col * g_sc
            a += tl.load(ga, mask=live, other=0.0).to(tl.float32)
            b += tl.load(ga + H * g_sc, mask=live, other=0.0).to(tl.float32)
        # tanh(|a|) = (1 - e) / (1 + e) with e = exp(-2|a|); near 0, where 1 - e
        # cancels, its series, so the result keeps its relative accuracy
        e = tl.exp(-2.0 * tl.abs(a))
        th = (1.0 - e) / (1.0 + e)
        th = tl.where(a < 0, -th, th)
        a2 = a * a
        th = tl.where(a2 < 1e-3, a * (1.0 - a2 * (1.0 / 3.0 - a2 * (2.0 / 15.0))), th)
        sg = 1.0 / (1.0 + tl.exp(-b))
        tl.store(out_ptr + idx, (th * sg).to(out_ptr.dtype.element_ty), mask=live)

    return gate_kernel


def fused_gate(x: torch.Tensor, g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., 2H) [+ g broadcastable] -> tanh(a) * sigmoid(b), (..., H)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_gate: dtype {x.dtype} not supported (float32 or bfloat16)")
    if x.ndim < 1 or x.shape[-1] % 2:
        raise ValueError(f"fused_gate: the last dimension of {tuple(x.shape)} must be even")
    if g is not None:
        g = torch.broadcast_to(g.to(x.dtype), x.shape)  # a view: broadcast dims get stride 0
    if x.device.type == "cpu":
        return fused_gate_plain(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gate: device {x.device} not supported")
    if not x.is_contiguous():
        raise ValueError("fused_gate kernel: x must be contiguous")
    if g is not None and x.ndim > 3:
        raise ValueError("fused_gate kernel: with g, x has at most 3 dimensions (B, T, 2H)")
    import triton

    h = x.shape[-1] // 2
    out = torch.empty(x.shape[:-1] + (h,), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    t = x.shape[-2] if x.ndim >= 2 else 1
    if g is None:
        g_arg, strides = x, (0, 0, 0)
    else:
        g_arg, strides = g, ((0, 0) + tuple(g.stride()))[-3:]
    with torch.cuda.device(x.device):
        _gate_kernel()[(triton.cdiv(out.numel(), BLOCK),)](
            x, g_arg, out, out.numel(), h, t, *strides, HAS_G=g is not None, BLOCK=BLOCK,
            num_warps=4)
    count_launches("fused_gate")
    return out

"""Fused WN (WaveNet-gate) stack: CUDA kernel + plain versions.

Counterpart of ``smart_vocoder_tpu/kernels/wn_stack.py``. Per layer of an
unconditioned WN stack (reference modules.py:148-176): a k=5 dilation-1 conv
H -> 2H plus bias, ``tanh(a) * sigmoid(b)``, a 1x1 res/skip conv, ``x = (x +
res) * mask`` and the skip halves summed; the last layer of the stack is
skip-only. :func:`wn_stack` replaces ``fused_wn_stack``: one launch of
``csrc/wn_stack.cu:svt_wn_stack`` per chunk of ``layers_per_call`` layers, as
the TPU kernel runs one ``pallas_call`` per chunk, and the same rounding
points (:func:`wn_stack_plain` mirrors them on a CPU tensor and is the
version the kernel is held against on the card):

- weights and biases are rounded to ``x.dtype``; each conv accumulates in f32;
- the gate output is rounded to ``x.dtype`` before the 1x1 conv;
- ``x = (x + res.astype(x.dtype)) * mask`` runs in ``x.dtype``;
- the skip sum is f32 within a chunk, rounded to ``x.dtype`` at its end, and
  summed across chunks in ``x.dtype``.

The TPU kernel's row packing by 2 (``PACK``, ``pack_wn_layer``, the column
permutations) is a 128-lane trick and is not ported; ``T % 2 == 0`` stays part
of the contract. :func:`wn_stack_reference` is the counterpart of
``kernels/encoder.py:_wn_stack_xla``: cuDNN convolutions with the same layer
algebra, rounded per op as XLA rounds them.

:func:`pack_wn_stack` puts a stack's weights into the kernel's layout once,
for a caller that serves many requests; :func:`wn_chunk` and
:func:`wn_chunk_plain` are one launch and its plain version.
"""

from __future__ import annotations

from typing import List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from smart_vocoder_torch.kernels._build import launch, load_library, pick_tile

WNLayer = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# (w_in (2H, H, k), b_in (2H,), w_rs (2H or H, H, 1), b_rs) in torch's layout

WN_HIDDEN = (192,)  # the kernel is instantiated for these hidden widths
KERNEL_SIZE = 5


def wn_layers_from_state_dict(state: Mapping[str, torch.Tensor], prefix: str,
                              n_layers: int) -> List[WNLayer]:
    """Per-layer (w_in, b_in, w_rs, b_rs) of the folded WN at ``prefix``
    (e.g. ``enc_p.encoder``): counterpart of ``wn_layers_from_params``."""
    return [(state[f"{prefix}.in_layers.{i}.weight"], state[f"{prefix}.in_layers.{i}.bias"],
             state[f"{prefix}.res_skip_layers.{i}.weight"],
             state[f"{prefix}.res_skip_layers.{i}.bias"]) for i in range(n_layers)]


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).float()


def _check(x: torch.Tensor, x_mask: torch.Tensor, layers: Sequence[WNLayer],
           hidden: int, layers_per_call: int, last_skip_only: bool = True) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"wn_stack: dtype {x.dtype} not supported (float32 or bfloat16)")
    if x.ndim != 3 or x.shape[2] != hidden or x.shape[1] % 2:
        raise ValueError(f"wn_stack: expected (B, T, {hidden}) with even T, got "
                         f"{tuple(x.shape)}")
    if tuple(x_mask.shape) != (x.shape[0], x.shape[1], 1):
        raise ValueError(f"wn_stack: mask {tuple(x_mask.shape)} is not (B, T, 1)")
    if layers_per_call < 1 or not layers:
        raise ValueError("wn_stack: at least one layer and layers_per_call >= 1")
    for i, (w_in, b_in, w_rs, b_rs) in enumerate(layers):
        rs = hidden if last_skip_only and i == len(layers) - 1 else 2 * hidden
        if (tuple(w_in.shape) != (2 * hidden, hidden, KERNEL_SIZE)
                or tuple(b_in.shape) != (2 * hidden,)
                or tuple(w_rs.shape) != (rs, hidden, 1) or tuple(b_rs.shape) != (rs,)):
            raise ValueError(f"wn_stack: layer {i} weights do not match hidden={hidden}, "
                             f"k={KERNEL_SIZE}")


def _chunks(layers: Sequence[WNLayer], layers_per_call: int):
    return [layers[s:s + layers_per_call] for s in range(0, len(layers), layers_per_call)]


def wn_chunk_plain(x: torch.Tensor, x_mask: torch.Tensor, chunk: Sequence[WNLayer],
                   hidden: int, skip: torch.Tensor, final: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of one launch of the kernel: ``chunk`` of layers over
    the state ``x (B, T, H)``, with ``skip`` the running sum of the earlier
    chunks -> (state, running skip sum) in ``x.dtype``; ``final`` masks the
    sum. f32 arithmetic that rounds to ``x.dtype`` exactly where the JAX
    kernel rounds (module docstring)."""
    dt = x.dtype
    rnd = (lambda v: v.to(dt).float()) if dt == torch.bfloat16 else (lambda v: v)
    m = _round(x_mask, dt).transpose(1, 2)  # (B, 1, T)
    xs = x.float().transpose(1, 2)
    acc = torch.zeros_like(xs)
    for w_in, b_in, w_rs, b_rs in chunk:
        a = F.conv1d(xs, _round(w_in, dt), _round(b_in, dt), padding=(KERNEL_SIZE - 1) // 2)
        acts = rnd(torch.tanh(a[:, :hidden]) * torch.sigmoid(a[:, hidden:]))
        rs = F.conv1d(acts, _round(w_rs, dt), _round(b_rs, dt))
        if rs.shape[1] == 2 * hidden:
            xs = rnd(rnd(xs + rnd(rs[:, :hidden])) * m)
            acc = acc + rs[:, hidden:]
        else:
            acc = acc + rs
    total = rnd(skip.float().transpose(1, 2) + rnd(acc))
    if final:
        total = rnd(total * m)
    return xs.transpose(1, 2).to(dt), total.transpose(1, 2).to(dt)


def wn_stack_plain(x: torch.Tensor, x_mask: torch.Tensor, layers: Sequence[WNLayer],
                   hidden: int, layers_per_call: int = 4) -> torch.Tensor:
    """Plain version of :func:`wn_stack`: :func:`wn_chunk_plain` over the
    chunks of ``layers_per_call`` layers."""
    skip = torch.zeros_like(x)
    chunks = _chunks(layers, layers_per_call)
    for n, chunk in enumerate(chunks):
        x, skip = wn_chunk_plain(x, x_mask, chunk, hidden, skip, n == len(chunks) - 1)
    return skip


def wn_stack_reference(x: torch.Tensor, x_mask: torch.Tensor, layers: Sequence[WNLayer],
                       hidden: int) -> torch.Tensor:
    """The plain WN stack of the serving path without the kernel (port of
    ``_wn_stack_xla``, encoder.py:129-149): cuDNN convolutions in
    ``x.dtype``, the output of each bf16 op rounded as XLA rounds it."""
    dt = x.dtype
    m = x_mask.to(dt).transpose(1, 2)
    xs = x.transpose(1, 2)
    out = torch.zeros_like(xs)
    for i, (w_in, b_in, w_rs, b_rs) in enumerate(layers):
        a = F.conv1d(xs, w_in.to(dt), padding=(w_in.shape[-1] - 1) // 2) + b_in.to(dt)[:, None]
        acts = torch.tanh(a[:, :hidden]) * torch.sigmoid(a[:, hidden:])
        rs = F.conv1d(acts, w_rs.to(dt)) + b_rs.to(dt)[:, None]
        if i < len(layers) - 1:
            xs = (xs + rs[:, :hidden]) * m
            out = out + rs[:, hidden:]
        else:
            out = out + rs
    return (out * m).transpose(1, 2)


class PackedChunk(NamedTuple):
    """One chunk's weights as the kernel reads them, f32 values rounded to
    ``dtype``: w_in (n, 5, H, 2H), b_in (n, 2H), w_rs (n, H, 2H), b_rs
    (n, 2H); a skip-only layer has a zero res half."""
    w_in: torch.Tensor
    b_in: torch.Tensor
    w_rs: torch.Tensor
    b_rs: torch.Tensor
    dtype: torch.dtype


def _pack_chunk(chunk: Sequence[WNLayer], hidden: int, dt: torch.dtype, device) -> PackedChunk:
    w_in, b_in, w_rs, b_rs = [], [], [], []
    for wi, bi, wr, br in chunk:
        w_in.append(_round(wi, dt).permute(2, 1, 0))
        b_in.append(_round(bi, dt))
        wr, br = _round(wr[:, :, 0], dt).t(), _round(br, dt)
        if wr.shape[1] == hidden:
            wr = torch.cat([torch.zeros_like(wr), wr], dim=1)
            br = torch.cat([torch.zeros_like(br), br])
        w_rs.append(wr)
        b_rs.append(br)
    return PackedChunk(*[torch.stack(a).to(device=device, dtype=torch.float32).contiguous()
                         for a in (w_in, b_in, w_rs, b_rs)], dt)


def pack_wn_stack(layers: Sequence[WNLayer], hidden: int, dtype: torch.dtype,
                  layers_per_call: int = 4, device=None) -> List[PackedChunk]:
    """The stack's weights in the kernel's layout, one :class:`PackedChunk`
    per launch: made once per stack and passed to :func:`wn_stack` as
    ``packed``, so a request does not re-round and re-stack them."""
    return [_pack_chunk(chunk, hidden, dtype, device)
            for chunk in _chunks(layers, layers_per_call)]


def _check_packed(x: torch.Tensor, chunks, packed: Sequence[PackedChunk]) -> None:
    if len(packed) != len(chunks) or any(
            p.dtype != x.dtype or p.w_in.shape[0] != len(c) or p.w_in.device != x.device
            for p, c in zip(packed, chunks)):
        raise ValueError("wn_stack: packed weights do not match the layers, their chunking, "
                         "x.dtype or x.device")


def _launch_chunk(x: torch.Tensor, mask: torch.Tensor, packed: PackedChunk, hidden: int,
                  skip: torch.Tensor, final: bool) -> torch.Tensor:
    """One launch of ``svt_wn_stack``: adds the chunk's skip sum into
    ``skip`` in place and returns the new state."""
    bsz, t, _ = x.shape
    n_layers = packed.w_in.shape[0]
    halo = (KERNEL_SIZE - 1) // 2 * n_layers
    # state and gate buffers over the haloed tile, the tile's skip sum, the mask
    tile = pick_tile(lambda tl: 4 * (2 * (tl + 2 * halo) * (hidden + 1) + tl * hidden
                                     + tl + 2 * halo))
    x_out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        launch("wn_stack", load_library().svt_wn_stack, x.data_ptr(), mask.data_ptr(),
               x_out.data_ptr(), skip.data_ptr(), packed.w_in.data_ptr(),
               packed.b_in.data_ptr(), packed.w_rs.data_ptr(), packed.b_rs.data_ptr(), bsz, t,
               hidden, tile, n_layers, int(final), int(x.dtype == torch.bfloat16))
    return x_out


def _kernel_inputs(name: str, x: torch.Tensor, x_mask: torch.Tensor, hidden: int):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: device {x.device} not supported")
    if hidden not in WN_HIDDEN:
        raise ValueError(f"{name} kernel: hidden={hidden} not in {WN_HIDDEN}")
    if x.shape[0] > 65535:
        raise ValueError(f"{name} kernel: batch above 65535")
    bsz, t, _ = x.shape
    return x.contiguous(), _round(x_mask, x.dtype).reshape(bsz, t).contiguous()


def wn_chunk(x: torch.Tensor, x_mask: torch.Tensor, chunk: Sequence[WNLayer], hidden: int,
             skip: torch.Tensor, final: bool, packed: Optional[PackedChunk] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on its own: (state, running skip sum), as
    :func:`wn_chunk_plain` computes them. :func:`wn_stack` is these launches
    in a row; this entry point lets a check give each launch the same input
    as its plain version."""
    _check(x, x_mask, chunk, hidden, len(chunk), last_skip_only=final)
    if tuple(skip.shape) != tuple(x.shape) or skip.dtype != x.dtype:
        raise ValueError("wn_chunk: skip must have x's shape and dtype")
    if packed is not None:
        _check_packed(x, [chunk], [packed])
    if x.device.type == "cpu":
        return wn_chunk_plain(x, x_mask, chunk, hidden, skip, final)
    x, mask = _kernel_inputs("wn_chunk", x, x_mask, hidden)
    if packed is None:
        packed = _pack_chunk(chunk, hidden, x.dtype, x.device)
    skip = skip.contiguous().clone()
    return _launch_chunk(x, mask, packed, hidden, skip, final), skip


def wn_stack(x: torch.Tensor, x_mask: torch.Tensor, layers: Sequence[WNLayer], hidden: int,
             layers_per_call: int = 4,
             packed: Optional[Sequence[PackedChunk]] = None) -> torch.Tensor:
    """WN stack over ``x (B, T, H)`` (masked input) with ``x_mask (B, T, 1)``
    -> the masked sum of the skips, ``(B, T, H)`` in ``x.dtype`` (port of
    ``fused_wn_stack``; g=None). bf16 or f32; even T. ``packed``: the
    weights from :func:`pack_wn_stack` for this dtype and chunking, else
    they are packed on each call."""
    _check(x, x_mask, layers, hidden, layers_per_call)
    chunks = _chunks(layers, layers_per_call)
    if packed is not None:
        _check_packed(x, chunks, packed)
    if x.device.type == "cpu":
        return wn_stack_plain(x, x_mask, layers, hidden, layers_per_call)
    x, mask = _kernel_inputs("wn_stack", x, x_mask, hidden)
    if packed is None:
        packed = pack_wn_stack(layers, hidden, x.dtype, layers_per_call, x.device)
    skip = torch.zeros_like(x)
    for n, p in enumerate(packed):
        x = _launch_chunk(x, mask, p, hidden, skip, n == len(packed) - 1)
    return skip

"""Fused WN (WaveNet-gate) stack: CUDA kernels + plain versions.

Counterpart of ``smart_vocoder_tpu/kernels/wn_stack.py``. Per layer of an
unconditioned WN stack (reference modules.py:148-176): a k=5 dilation-1 conv
H -> 2H plus bias, ``tanh(a) * sigmoid(b)``, a 1x1 res/skip conv, ``x = (x +
res) * mask`` and the skip halves summed; the last layer of the stack is
skip-only. :func:`wn_stack` replaces ``fused_wn_stack``: one launch of
``csrc/wn_stack.cu`` per chunk of ``layers_per_call`` layers, as the TPU
kernel runs one ``pallas_call`` per chunk -- ``svt_wn_stack`` on the tensor
cores for a bf16 ``x`` (bf16 ``wgmma`` with f32 accumulation; every operand
is a bf16 value in that mode), ``svt_wn_stack_fma`` on the CUDA cores for an
f32 one (f32 weights, counted as ``wn_stack_fma``) -- with the same rounding
points (:func:`wn_stack_plain` mirrors them on a CPU tensor and is the
version the kernels are held against on the card):

- weights and biases are rounded to ``x.dtype``; each conv accumulates in f32;
- the gate output is rounded to ``x.dtype`` before the 1x1 conv;
- ``x = (x + res.astype(x.dtype)) * mask`` runs in ``x.dtype``;
- the skip sum is f32 within a chunk, rounded to ``x.dtype`` at its end, and
  summed across chunks in ``x.dtype``.

The TPU kernel's row packing by 2 (``PACK``, ``pack_wn_layer``, the column
permutations) is a 128-lane trick and is not ported; ``T % 2 == 0`` stays part
of the contract. The tensor-core kernel has its own column order instead:
each pass of 128 columns holds 64 tanh columns beside their sigmoid partners
(64 res beside 64 skip), so one thread forms a gate from two accumulators
(:class:`PackedChunk`). :func:`wn_stack_reference` is the counterpart of
``kernels/encoder.py:_wn_stack_xla``: cuDNN convolutions with the same layer
algebra, rounded per op as XLA rounds them.

:func:`pack_wn_stack` puts a stack's weights into the kernels' layout once,
for a caller that serves many requests; :func:`wn_chunk` and
:func:`wn_chunk_plain` are one launch and its plain version.
"""

from __future__ import annotations

from typing import List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from smart_vocoder_torch.kernels._build import SMEM_LIMIT, launch, load_library, pick_tile
from smart_vocoder_torch.kernels.mrf import MMA_MAX_ROWS, MMA_PAD, MMA_STAGES, _tile_layout

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
    """One chunk's weights as its kernel reads them, rounded to ``dtype``.
    ``w`` (n, ...): per layer the in-conv's weights, then the 1x1 conv's. In
    bf16, tiles of 64 input channels by 128 columns in the ``wgmma`` layout:
    pass p of the in-conv holds tanh columns 64p.. beside sigmoid columns
    H + 64p.., [pass][tap][Cin / 64]; pass p of the 1x1 conv res beside skip,
    [pass][Cin / 64] (a skip-only layer: skip beside zeros). In f32, w_in
    (5, H, 2H) [tap][in][tanh | sigmoid] and w_rs (H, 2H) [in][res | skip]
    (a skip-only layer with a zero res half). ``b_in``, ``b_rs`` (n, 2H) f32
    in the columns' order. ``last_skip_only``: the chunk ends the stack."""
    w: torch.Tensor
    b_in: torch.Tensor
    b_rs: torch.Tensor
    dtype: torch.dtype
    last_skip_only: bool


PASS = 64  # columns of each half of a bf16 pass: a pass is 2 x 64


def _pair_columns(a: torch.Tensor, b: Optional[torch.Tensor], hidden: int) -> torch.Tensor:
    """Columns (..., H) of a and of b (zeros where b is None) interleaved by
    passes: [a 0:64 | b 0:64 | a 64:128 | b 64:128 | ...] -> (..., 2H)."""
    b = torch.zeros_like(a) if b is None else b
    parts = [t[..., p:p + PASS] for p in range(0, hidden, PASS) for t in (a, b)]
    return torch.cat(parts, dim=-1)


def _tiles(w: torch.Tensor, hidden: int) -> torch.Tensor:
    """(taps, H, 2H) weights whose columns are in pass order -> flat tiles
    [pass][tap][Cin / 64] of (64, 128) in the ``wgmma`` layout."""
    taps = w.shape[0]
    t = w.reshape(taps, hidden // 64, 64, hidden // PASS, 2 * PASS).permute(3, 0, 1, 2, 4)
    return _tile_layout(t.reshape(-1, 64, 2 * PASS), wgmma=True).reshape(-1)


def _pack_chunk(chunk: Sequence[WNLayer], hidden: int, dt: torch.dtype, device) -> PackedChunk:
    w, b_in, b_rs = [], [], []
    for wi, bi, wr, br in chunk:
        wi, bi = _round(wi, dt).permute(2, 1, 0), _round(bi, dt)  # (5, H, 2H)
        wr, br = _round(wr[:, :, 0], dt).t(), _round(br, dt)      # (H, 2H or H)
        res, skip = (None, wr) if wr.shape[1] == hidden else (wr[:, :hidden], wr[:, hidden:])
        bres, bskip = (None, br) if br.shape[0] == hidden else (br[:hidden], br[hidden:])
        if dt == torch.bfloat16:
            h = hidden
            w.append(torch.cat([_tiles(_pair_columns(wi[..., :h], wi[..., h:], h), h),
                                _tiles(_pair_columns(skip, None, h)[None] if res is None else
                                       _pair_columns(res, skip, h)[None], h)]))
            b_in.append(_pair_columns(bi[:h], bi[h:], h))
            b_rs.append(_pair_columns(bskip, None, h) if bres is None
                        else _pair_columns(bres, bskip, h))
        else:
            zero = torch.zeros_like(skip)
            w.append(torch.cat([wi.reshape(-1),
                                torch.cat([zero if res is None else res, skip], 1).reshape(-1)]))
            b_in.append(bi)
            b_rs.append(torch.cat([torch.zeros_like(bskip) if bres is None else bres, bskip]))
    w = torch.stack(w).to(device=device, dtype=torch.bfloat16 if dt == torch.bfloat16
                          else torch.float32).contiguous()
    return PackedChunk(w, *[torch.stack(a).to(device=device, dtype=torch.float32).contiguous()
                            for a in (b_in, b_rs)], dt, chunk[-1][2].shape[0] == hidden)


def pack_wn_stack(layers: Sequence[WNLayer], hidden: int, dtype: torch.dtype,
                  layers_per_call: int = 4, device=None) -> List[PackedChunk]:
    """The stack's weights in the kernel's layout, one :class:`PackedChunk`
    per launch: made once per stack and passed to :func:`wn_stack` as
    ``packed``, so a request does not re-round and re-lay them out."""
    return [_pack_chunk(chunk, hidden, dtype, device)
            for chunk in _chunks(layers, layers_per_call)]


def _check_packed(x: torch.Tensor, chunks, packed: Sequence[PackedChunk]) -> None:
    if len(packed) != len(chunks) or any(
            p.dtype != x.dtype or p.w.shape[0] != len(c) or p.w.device != x.device
            or p.last_skip_only != (c[-1][2].shape[0] == x.shape[2])
            for p, c in zip(packed, chunks)):
        raise ValueError("wn_stack: packed weights do not match the layers, their chunking, "
                         "x.dtype or x.device")


# The tensor-core kernel's geometry, mirrored from csrc/wn_stack.cu:smem_bytes.
WN_TILES = (96, 64, 32)


def wn_smem_bytes(hidden: int, tile: int, n_layers: int) -> int:
    """Shared memory of one block of the tensor-core kernel: the f32 skip sum
    of the tile's rows, the bf16 state and gate buffers over the haloed tile
    (rows padded by 16 bytes), the mask, and the ring of (64, 128) tiles."""
    rows = tile + (KERNEL_SIZE - 1) * n_layers
    return (tile * (hidden + MMA_PAD) * 4 + 2 * rows * (hidden + MMA_PAD) * 2
            + (rows + 3) // 4 * 4 * 4 + MMA_STAGES * 64 * (2 * PASS + MMA_PAD) * 2)


def wn_tile(hidden: int, n_layers: int) -> int:
    """The time tile of the tensor-core kernel: the largest of ``WN_TILES``
    that fits in shared memory and whose first layer's rows, tile + 4n - 4,
    its four warpgroups cover (64 at 4 layers a chunk)."""
    for tile in WN_TILES:
        if (tile + 4 * n_layers - 4 <= MMA_MAX_ROWS
                and wn_smem_bytes(hidden, tile, n_layers) <= SMEM_LIMIT):
            return tile
    raise ValueError("wn_stack: the kernel does not fit in shared memory")


def _launch_chunk(x: torch.Tensor, mask: torch.Tensor, packed: PackedChunk, hidden: int,
                  skip: torch.Tensor, final: bool) -> torch.Tensor:
    """One launch of ``svt_wn_stack`` (bf16, tensor cores) or
    ``svt_wn_stack_fma`` (f32): adds the chunk's skip sum into ``skip`` in
    place and returns the new state."""
    bsz, t, _ = x.shape
    n_layers = packed.w.shape[0]
    x_out = torch.empty_like(x)
    args = (x.data_ptr(), mask.data_ptr(), x_out.data_ptr(), skip.data_ptr(),
            packed.w.data_ptr(), packed.b_in.data_ptr(), packed.b_rs.data_ptr(), bsz, t, hidden)
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            launch("wn_stack", load_library().svt_wn_stack, *args, wn_tile(hidden, n_layers),
                   n_layers, int(final), int(packed.last_skip_only))
        else:
            halo = (KERNEL_SIZE - 1) // 2 * n_layers
            # state and gate buffers over the haloed tile, the tile's skip sum, the mask
            tile = pick_tile(lambda tl: 4 * (2 * (tl + 2 * halo) * (hidden + 1) + tl * hidden
                                             + tl + 2 * halo))
            launch("wn_stack_fma", load_library().svt_wn_stack_fma, *args, tile, n_layers,
                   int(final))
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

"""Fused multi-receptive-field (MRF) decoder stages: CUDA kernels + plain versions.

One HiFi-GAN MRF stage is the mean over the ResBlock1 branches; the branch
with kernel size k runs the residual pairs ``x += c2(lrelu(c1_d(lrelu(x))))``
for dilations d in (1, 3, 5) -- 18 convolutions for the 3 branches. Every
intermediate is zeroed outside the real sequence ``[0, T)`` (the zero padding
torch gives each conv at the true boundary).

Three kernels, counterparts of the JAX package's Pallas kernels:

- :func:`mrf_stage` replaces ``smart_vocoder_tpu/kernels/mrf.py:
  fused_mrf_stage_packed`` (decoder stage 3);
- :func:`mrf_stage_unpacked` replaces ``fused_mrf_stage`` (the unpacked
  stage in ``x.dtype``: stage 2, and stage 1 when its length allows, under
  ``decoder_apply(pallas_stage2=True)``; the forward of ``mrf_stage_train``)
  and, with ``f32_storage``, the XLA convolutions of
  ``mrf_stage_reference(mixed_f32=True)`` (stages 1-2 at hifi >= 2);
- :func:`up_mrf_stage` replaces ``fused_up_mrf_stage`` (decoder stage 4, or
  stage 3 under ``pallas_stage2``): lrelu -> ConvTranspose1d upsample -> the
  MRF stage, optionally followed by the decoder tail lrelu(0.01) -> conv_post
  -> tanh.

They compute the *function* of the TPU kernels, not their block structure
(space-to-depth packing, per-tap weights and the DMA'd mask are TPU lane
tricks). Each wrapper launches its CUDA kernel for a CUDA tensor, or raises;
for a CPU tensor it runs the plain PyTorch version beside it
(:func:`mrf_stage_plain`, :func:`up_mrf_stage_plain`), which the tests and
``chip_smoke.py`` hold the kernels against. ``mrf_stage_unpacked`` is
``fused_mrf_stage``'s contract, which is the BF16 mode for a bf16 ``x`` and
the F32 mode for an f32 one (F32_STORAGE with ``f32_storage``), so its plain
version is ``mrf_stage_plain``.

What bounds the three on the card is arithmetic (a stage is 252*C*C FLOP a
row against a few hundred bytes), so their kernels (``csrc/mrf_stage.cu``,
and ``csrc/mrf_pair.cu`` for the unpacked stage at C = 32-256, whose GEMMs at
C >= 128 run as one pass of C columns, :func:`pair_geometry`) run every
conv, and the polyphase upsample, on the tensor cores with bf16 operands and f32 accumulation over
bf16 operand buffers in shared memory: ``wgmma.m64n64k16`` at 64 channels (A
from registers through ``ldmatrix``, the weight tile through a shared-memory
descriptor), ``mma.sync.m16n8k16`` at 32. The weights are bf16 tiles in the
order of use, in the layout the MMA's B operand wants
(:func:`pack_mrf_stage`, :func:`pack_up_mrf_stage`: made once per weight set
by the caller and passed as ``packed``, else made on each call), and are
streamed through a shared-memory ring. What bounds them now is the
shared-memory traffic of that loop and one block-wide barrier per tap. The
tile is the largest whose buffers fit in a block's shared memory and whose
haloed rows the block's warps cover (:func:`mrf_stage_tile`,
:func:`up_mrf_stage_tile`). That holds wherever the weights are bf16 values,
which is every serving mode; for true-f32 weights (an f32 ``x``; an f32 ``u``
without ``hifi``) the wrappers launch the f32 FMA kernels of
``csrc/mrf_stage_fma.cu`` instead, since a product of bf16 pairs does not
compute an f32 x f32 convolution; those launches count as ``mrf_stage_fma``,
``up_mrf_stage_fma`` and ``mrf_stage_unpacked_fma``.

Precision modes (one int flag of the kernels, mirrored by the plain
versions, which compute in float32 and round explicitly where the JAX
kernels cast):

- ``BF16``: conv operands, every stored intermediate, residual sum and the
  output are bf16 (f32 accumulation); the leaky slope and its product are
  bf16 too, as JAX evaluates ``x * 0.1`` on a bf16 array.
- ``F32_STORAGE``: f32 storage and output, each conv operand rounded once to
  bf16 (``fused_mrf_stage_packed(f32_storage=True)``, hifi levels 1-2; and
  ``mrf_stage_reference(mixed_f32=True)``, hifi >= 2's early decoder).
- ``F32``: no rounding of activations. This is the JAX f32 mode and also its
  ``x2`` / ``hifi`` modes: there the kernels, like the JAX ones, take each
  f32 operand as a hi + lo pair of bf16 values (:func:`split_hi_lo`), which
  reconstructs it to ~2^-16, and multiply both against the bf16-valued
  weight; the plain versions compute the f32 product directly.

In every mode the weights and biases arrive rounded as the JAX wrappers round
them (``x.dtype`` for the MRF stage, bf16 under ``hifi`` for the up stage).

:func:`mrf_stage` also takes the options of the packed-MRF A/B variants
(``scripts/exp_mrf_variants.py:fused_variant``, driven here by
``tools/exp_mrf_variants.py``): ``mask_edges=False`` is its ``use_mask=False``
(no zeroing outside ``[0, T)`` after each conv: the chain runs on the
zero-extended input, so biases leak in from the padding within one radius of
the ends) and ``out_dtype=torch.bfloat16`` under ``f32_storage`` is its
``acc_dtype=float32`` (f32 chain state, bf16 conv operands, bf16 output).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# LAUNCHES / reset_launch_counts: the kernels' shared launch counts, re-exported here
from smart_vocoder_torch.kernels._build import (  # noqa: F401
    LAUNCHES,
    SMEM_LIMIT,
    launch,
    load_library,
    pick_tile,
    reset_launch_counts,
)

LRELU_SLOPE = 0.1
POST_SLOPE = 0.01  # decoder tail: torch's default leaky_relu slope (models.py:156)
DILATIONS = (1, 3, 5)

BF16, F32_STORAGE, F32 = 0, 1, 2

BranchWeights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# (w1 (n_pairs, k, C, C) [tap, in, out], b1 (n_pairs, C), w2 (same), b2 (same))

MRF_CHANNELS = (32, 64)  # the kernels are instantiated for these channel counts
UNPACKED_CHANNELS = (32, 64, 128, 256)
F32S_CHANNELS = (128, 256)  # the unpacked stage's F32_STORAGE kernel: multiples of 128
UP_CHANNELS = ((64, 32), (128, 64))  # (Cin, Cout)


def stage_radius(kernel_sizes: Sequence[int], dilations: Sequence[int] = DILATIONS) -> int:
    """Receptive radius of one branch chain, maxed over branches (mrf.py:46)."""
    return max((k - 1) // 2 * sum(d + 1 for d in dilations) for k in kernel_sizes)


# ---------------------------------------------------------------- plain versions
def _rbf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _bf16_value(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.bfloat16))


def _leaky(x: torch.Tensor, slope: float, mode: int) -> torch.Tensor:
    if mode == BF16:
        return torch.maximum(x, _rbf(x * _bf16_value(slope)))
    return torch.maximum(x, x * slope)


def _operand(v: torch.Tensor, mode: int) -> torch.Tensor:
    """Conv operand lrelu(v) at the mode's precision."""
    a = _leaky(v, LRELU_SLOPE, mode)
    return _rbf(a) if mode == F32_STORAGE else a


def _store(v: torch.Tensor, mode: int) -> torch.Tensor:
    return _rbf(v) if mode == BF16 else v


def split_hi_lo(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An f32 tensor as the two bf16 planes the F32-mode kernels multiply:
    ``hi`` is x's upper 16 bits (a bf16 value by truncation), ``lo`` the bf16
    rounding of ``x - hi`` (exact in f32). ``hi + lo`` reconstructs x to within
    2^-16 |x|. Both planes are returned as f32 holding bf16 values."""
    x = x.float().contiguous()
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return hi, _rbf(x - hi)


def _hio_to_oik(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 1, 0)


def _mrf_chain(x: torch.Tensor, branches: List[BranchWeights], kernel_sizes,
               dilations, mode: int, mask_edges: bool = True) -> torch.Tensor:
    """f32 (B, C, T) stage input -> f32 mean of the branch outputs. Without
    ``mask_edges`` the chain runs on x extended by one stage radius of zeros
    (within which a conv's own zero padding cannot reach the real rows)."""
    if not mask_edges:
        r = stage_radius(kernel_sizes, dilations)
        return _mrf_chain(F.pad(x, (r, r)), branches, kernel_sizes, dilations,
                          mode)[..., r:r + x.shape[-1]]
    acc = torch.zeros_like(x)
    for (w1, b1, w2, b2), k in zip(branches, kernel_sizes):
        xb = x
        for j, d in enumerate(dilations):
            xt = _store(F.conv1d(_operand(xb, mode), _hio_to_oik(w1[j]).float(),
                                 b1[j].float(), padding=d * (k - 1) // 2, dilation=d), mode)
            xt = _store(F.conv1d(_operand(xt, mode), _hio_to_oik(w2[j]).float(),
                                 b2[j].float(), padding=(k - 1) // 2), mode)
            xb = _store(xt + xb, mode)
        acc = acc + xb
    return acc / len(branches)


def mrf_stage_plain(x: torch.Tensor, branches: List[BranchWeights],
                    kernel_sizes: Sequence[int], dilations: Sequence[int], mode: int,
                    mask_edges: bool = True, out_bf16: Optional[bool] = None
                    ) -> torch.Tensor:
    """Plain version of :func:`mrf_stage`: x (B, T, C) -> (B, T, C), bf16 in
    BF16 mode (or with ``out_bf16``), else f32. Weights already rounded by the
    caller."""
    y = _mrf_chain(x.float().transpose(1, 2), branches, kernel_sizes, dilations, mode,
                   mask_edges)
    y = y.transpose(1, 2)
    if out_bf16 is None:
        out_bf16 = mode == BF16
    return y.to(torch.bfloat16) if out_bf16 else y.contiguous()


def up_mrf_stage_plain(u: torch.Tensor, up_weight: torch.Tensor, up_bias: torch.Tensor,
                       up_stride: int, up_padding: int, branches: List[BranchWeights],
                       kernel_sizes: Sequence[int], dilations: Sequence[int], mode: int,
                       post_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`up_mrf_stage`: u (B, Tu, Cin) -> (B, Tu*s, Cout),
    or the waveform (B, Tu*s, 1) with ``post_weight`` (torch (1, Cout, k))."""
    x = F.conv_transpose1d(_operand(u.float().transpose(1, 2), mode), up_weight.float(),
                           up_bias.float(), stride=up_stride, padding=up_padding)
    y = _store(_mrf_chain(_store(x, mode), branches, kernel_sizes, dilations, mode), mode)
    if post_weight is not None:
        z = _leaky(y, POST_SLOPE, mode)
        y = torch.tanh(F.conv1d(z, post_weight.float(),
                                padding=(post_weight.shape[-1] - 1) // 2))
    y = y.transpose(1, 2)
    return y.to(torch.bfloat16) if mode == BF16 else y.contiguous()


def leaky_native(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    """``max(x, slope * x)`` in x's own dtype, with the slope rounded to it as
    JAX rounds a Python scalar against a bf16 array (``jax.nn.leaky_relu``)."""
    return torch.maximum(x, x * (_bf16_value(slope) if x.dtype == torch.bfloat16 else slope))


def mrf_stage_reference(x: torch.Tensor, branches: List[BranchWeights],
                        kernel_sizes: Sequence[int], dilations: Sequence[int] = DILATIONS,
                        mixed_f32: bool = False) -> torch.Tensor:
    """The decoder's plain MRF stage (port of ``mrf_stage_reference``,
    mrf.py:695-729), over ``x (B, T, C)``: cuDNN convolutions, computed in
    x's dtype and rounded per op as XLA rounds them (a bf16 conv rounds its
    output, then its bias add rounds again).

    ``mixed_f32``: f32 activations and residuals, each conv operand rounded
    once to bf16 and accumulated in f32 (hifi >= 2's early decoder); the
    branch weights and biases are then bf16 values held in f32."""
    xb0 = x.transpose(1, 2)

    def conv(v, w, b, k, d):
        w = _hio_to_oik(w)
        if mixed_f32:
            return F.conv1d(_rbf(v), w.float(), b.float(), padding=d * (k - 1) // 2,
                            dilation=d)
        y = F.conv1d(v, w.to(v.dtype), padding=d * (k - 1) // 2, dilation=d)
        return y + b.to(v.dtype)[:, None]

    acc = None
    for (w1, b1, w2, b2), k in zip(branches, kernel_sizes):
        xb = xb0
        for j, d in enumerate(dilations):
            xt = conv(leaky_native(xb), w1[j], b1[j], k, d)
            xt = conv(leaky_native(xt), w2[j], b2[j], k, 1)
            xb = xt + xb
        acc = xb if acc is None else acc + xb
    return (acc / len(branches)).transpose(1, 2)


# ---------------------------------------------------------------- kernel wrappers
def _mrf_mode(x_dtype: torch.dtype, f32_storage: bool, x2: bool) -> int:
    if x_dtype == torch.bfloat16 and not x2:
        return F32_STORAGE if f32_storage else BF16
    return F32


def _round_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).float()


def _check_input(name: str, x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32 or bfloat16)")
    if x.ndim != 3:
        raise ValueError(f"{name}: expected (B, T, C), got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: device {x.device} not supported")


def _check_branches(branches, kernel_sizes, dilations, c: int) -> None:
    if not 1 <= len(branches) <= 3 or len(branches) != len(kernel_sizes):
        raise ValueError("1 to 3 branches, one kernel size each")
    if not 1 <= len(dilations) <= 3:
        raise ValueError("1 to 3 residual pairs per branch")
    for (w1, b1, w2, b2), k in zip(branches, kernel_sizes):
        if k % 2 == 0:
            raise ValueError(f"odd kernel sizes only, got {k}")
        for w in (w1, w2):
            if tuple(w.shape) != (len(dilations), k, c, c):
                raise ValueError(f"branch weight {tuple(w.shape)} != "
                                 f"{(len(dilations), k, c, c)}")
        for b in (b1, b2):
            if tuple(b.shape) != (len(dilations), c):
                raise ValueError(f"branch bias {tuple(b.shape)} != {(len(dilations), c)}")


def _flat_weights(branches, device) -> torch.Tensor:
    """f32 [branch][w1 of every pair, w2 of every pair][tap][Cin][Cout]."""
    w = torch.cat([torch.cat([w1.reshape(-1), w2.reshape(-1)]) for w1, _, w2, _ in branches])
    return w.to(device=device, dtype=torch.float32).contiguous()


def _flat_biases(branches, dtype: torch.dtype, device) -> torch.Tensor:
    """f32 [branch][b1 of every pair, b2 of every pair][C], rounded to ``dtype``."""
    b = torch.cat([torch.cat([b1.reshape(-1), b2.reshape(-1)]) for _, b1, _, b2 in branches])
    return _round_to(b, dtype).to(device).contiguous()


def _branch_ints(branches, kernel_sizes, dilations) -> List[int]:
    """The entry points' int arguments nb, k0..k2, np, d0..d2."""
    ks = list(kernel_sizes) + [0] * (3 - len(kernel_sizes))
    ds = list(dilations) + [0] * (3 - len(dilations))
    return [len(branches), *ks, len(dilations), *ds]


# The tensor-core kernels' geometry, mirrored from csrc/mrf_mma.cuh and
# csrc/mrf_stage.cu:smem_bytes.
MMA_MAX_ROWS = 256  # rows one GEMM covers: 16 warps of a 16-row tile (4 x 64 on wgmma)
MMA_STAGES = 4  # weight tiles in the shared-memory ring
MMA_PAD = 8  # elements of padding per shared-memory row
UP_TILE_ROWS = 64  # input channels per weight tile of the upsample


def mma_smem_bytes(c: int, ring_rows: int, rows: int, sum_rows: int, n_state: int,
                   planes: int) -> int:
    """Shared memory of one block of the tensor-core kernels: ``n_state`` f32
    state buffers of ``rows`` rows and the f32 branch sum, two bf16 operand
    buffers of ``planes`` planes (2 in F32 mode: hi and lo), and the ring of
    ``MMA_STAGES`` weight tiles of ``ring_rows`` rows; every row padded."""
    return ((n_state * rows + sum_rows) * (c + MMA_PAD) * 4
            + (2 * planes * rows + MMA_STAGES * ring_rows) * (c + MMA_PAD) * 2)


def mrf_stage_tile(c: int, mode: int, radius: int) -> int:
    """The time tile of :func:`mrf_stage`'s tensor-core kernel: the largest
    whose block fits in shared memory with tile + 2 * radius rows that the
    block's warps cover. (128 at C = 64 and the stage radius 60: 217 KB in the
    bf16-operand modes; F32 mode at C = 64 takes 64.)"""
    def smem(tile):
        rows = tile + 2 * radius
        if rows > MMA_MAX_ROWS:
            return SMEM_LIMIT + 1
        return mma_smem_bytes(c, c, rows, tile, 1, 2 if mode == F32 else 1)

    return pick_tile(smem)


def up_mrf_stage_tile(cin: int, c: int, mode: int, halo: int, p_post: int, up_kernel: int,
                      up_stride: int) -> int:
    """The time tile (output rows) of :func:`up_mrf_stage`'s tensor-core
    kernel, as :func:`mrf_stage_tile`; the block also keeps the upsampled
    stage input, and its u tile must fit in the two operand buffers it
    aliases until the branches start."""
    def smem(tile):
        rows = tile + 2 * halo
        u_rows = (rows + up_kernel) // up_stride + 2
        if rows > MMA_MAX_ROWS or u_rows * (cin + MMA_PAD) > 2 * rows * (c + MMA_PAD):
            return SMEM_LIMIT + 1
        return mma_smem_bytes(c, UP_TILE_ROWS, rows, tile + 2 * p_post, 2,
                              2 if mode == F32 else 1)

    return pick_tile(smem)


WGMMA_CHANNELS = 64  # the channel count whose stage GEMMs run on ``wgmma``
PAIR_TILES = (240, 128, 64, 32)  # the unpacked stage's candidate time tiles


class PairGeometry(NamedTuple):
    """The unpacked stage's block at one channel count (``csrc/mrf_pair.cu:
    PairGeometry``): threads and ring slots. Its GEMMs are one pass of all C
    columns; at C = 256 their 128 accumulators a thread need 8 warps, and
    the ring's 33 KB slots leave room for 3."""
    threads: int
    stages: int


def pair_geometry(c: int) -> PairGeometry:
    return PairGeometry(256, 3) if c == 256 else PairGeometry(512, MMA_STAGES)


def _tile_layout(tiles: torch.Tensor, wgmma: Optional[bool] = None) -> torch.Tensor:
    """Weight tiles (n, K, N) [Cin][Cout] in the layout their MMA reads:
    row-major as they are for ``mma.sync`` (``ldmatrix``); for ``wgmma`` (by
    default at N = 64) as it reads a K-major B operand without swizzle, 8 x 8
    core matrices of 128 contiguous bytes, [N / 8][K / 8][8 columns][8 rows]."""
    n, k, c = tiles.shape
    if not (c == WGMMA_CHANNELS if wgmma is None else wgmma):
        return tiles
    return tiles.reshape(n, k // 8, 8, c // 8, 8).permute(0, 3, 1, 4, 2)


def _conv_tiles(w: torch.Tensor) -> torch.Tensor:
    """One conv's weights (k, C, C) [tap][Cin][Cout] as the tiles its kernels
    consume: one (C, C) tile per tap at C <= 64; at C >= 128 (the unpacked
    stage) tiles of 64 input channels by C, [tap][Cin / 64], each in the
    ``wgmma`` layout."""
    k, c, _ = w.shape
    if c <= 64:
        return _tile_layout(w)
    return _tile_layout(w.reshape(-1, 64, c), wgmma=True)


def pack_mrf_weights(branches: List[BranchWeights], device=None) -> torch.Tensor:
    """The stage's conv weights as one flat bf16 tensor of tiles
    [branch][pair][conv1, conv2] (:func:`_conv_tiles` each): the order in
    which the tensor-core kernels consume them, tap by tap."""
    tiles = [_conv_tiles(w[j]).reshape(-1) for w1, _, w2, _ in branches
             for j in range(w1.shape[0]) for w in (w1, w2)]
    return torch.cat(tiles).to(device=device, dtype=torch.bfloat16).contiguous()


def unpacked_smem_bytes(c: int, tile: int, h: int, d: int) -> int:
    """Shared memory of one block of the unpacked stage's tensor-core kernel
    (``csrc/mrf_pair.cu:smem_bytes``) for a pair of radius h and dilation d:
    the operand of conv1 over tile + 2(h*d + h) rows and of conv2 over
    tile + 2h, bf16 with padded rows, and the ring of weight tiles (C x C
    at C <= 64, else 64 rows by C)."""
    rows = 64 if c >= 128 else c
    return ((2 * tile + 2 * (h * d + h) + 2 * h) * (c + MMA_PAD) * 2
            + pair_geometry(c).stages * rows * (c + MMA_PAD) * 2)


def unpacked_tile(c: int, kernel_sizes: Sequence[int], dilations: Sequence[int]) -> int:
    """The time tile of :func:`mrf_stage_unpacked`'s tensor-core kernel: the
    largest of ``PAIR_TILES`` whose every pair fits in a block's shared memory
    and whose conv1 rows, tile + 2h, its warpgroups cover (64 rows each).
    (240 at C <= 128 and k <= 11; 64 at C = 256.)"""
    h = max((k - 1) // 2 for k in kernel_sizes)
    for tile in PAIR_TILES:
        if tile + 2 * h <= pair_geometry(c).threads // 2 and all(
                unpacked_smem_bytes(c, tile, (k - 1) // 2, d) <= SMEM_LIMIT
                for k in kernel_sizes for d in dilations):
            return tile
    raise ValueError("mrf_stage_unpacked: the kernel does not fit in shared memory")


def up_tap_order(up_kernel: int, up_stride: int, up_padding: int) -> List[int]:
    """The ConvTranspose1d taps in the order of its polyphase form: output
    rows ``n = stride * j + phase`` take the taps ``t = (phase + padding) mod
    stride + i * stride``, each from input row ``j + (phase + padding - t) /
    stride``. (4, 2, 1): even rows taps 1 and 3, odd rows taps 0 and 2.)"""
    return [t for phase in range(up_stride)
            for t in range((phase + up_padding) % up_stride, up_kernel, up_stride)]


def pack_up_weights(up_weight: torch.Tensor, up_stride: int, up_padding: int,
                    device=None) -> torch.Tensor:
    """torch's ConvTranspose1d weight (Cin, Cout, k) as flat bf16 tiles
    [tap in :func:`up_tap_order`][Cin / 64], each [64][Cout] in
    :func:`_tile_layout`."""
    order = up_tap_order(up_weight.shape[2], up_stride, up_padding)
    w = up_weight.permute(2, 0, 1)[order]  # (k, Cin, Cout) in the order of use
    tiles = w.reshape(-1, UP_TILE_ROWS, w.shape[2])
    return _tile_layout(tiles).reshape(-1).to(device=device, dtype=torch.bfloat16).contiguous()


class PackedMRF(NamedTuple):
    """:func:`mrf_stage`'s weights as its tensor-core kernel reads them: ``w``
    the bf16 tiles of :func:`pack_mrf_weights`, ``bias`` f32 holding bf16
    values, [branch][b1 of every pair, b2 of every pair][C]."""
    w: torch.Tensor
    bias: torch.Tensor


class PackedUpMRF(NamedTuple):
    """:func:`up_mrf_stage`'s weights as its tensor-core kernel reads them:
    ``w`` the bf16 tiles of the upsample, then of the MRF convs; ``up_bias``
    and ``bias`` f32 holding bf16 values; ``post_weight`` conv_post's as
    (k_post, Cout), or one zero where there is no tail."""
    w: torch.Tensor
    up_bias: torch.Tensor
    bias: torch.Tensor
    post_weight: torch.Tensor


def pack_mrf_stage(branches: List[BranchWeights], device=None) -> PackedMRF:
    """The ``packed`` argument of :func:`mrf_stage` and
    :func:`mrf_stage_unpacked` for a bf16 ``x``: made once per weight set, so
    a request does not round and lay them out again."""
    return PackedMRF(pack_mrf_weights(branches, device),
                     _flat_biases(branches, torch.bfloat16, device))


def pack_up_mrf_stage(up_weight: torch.Tensor, up_bias: torch.Tensor, up_stride: int,
                      up_padding: int, branches: List[BranchWeights],
                      post_weight: Optional[torch.Tensor] = None, device=None) -> PackedUpMRF:
    """The ``packed`` argument of :func:`up_mrf_stage` where its weights are
    bf16 values (``hifi``, or a bf16 ``u``), as :func:`pack_mrf_stage`."""
    bf16 = torch.bfloat16
    wpost = (torch.zeros(1) if post_weight is None else _round_to(post_weight, bf16)[0].t())
    return PackedUpMRF(
        torch.cat([pack_up_weights(up_weight, up_stride, up_padding, device),
                   pack_mrf_weights(branches, device)]),
        _round_to(up_bias, bf16).to(device).contiguous(), _flat_biases(branches, bf16, device),
        wpost.to(device).contiguous())


def _check_packed(name: str, x: torch.Tensor, bf16_weights: bool, got: Sequence[torch.Tensor],
                  sizes: Sequence[int]) -> None:
    if not bf16_weights:
        raise ValueError(f"{name}: packed weights are bf16 tiles, and this input keeps its "
                         "weights in f32")
    if any(t.device != x.device or t.numel() != n for t, n in zip(got, sizes)):
        raise ValueError(f"{name}: packed weights do not match the branches, the channel "
                         "counts or x's device")


def mrf_stage(x: torch.Tensor, branches: List[BranchWeights], kernel_sizes: Sequence[int],
              dilations: Sequence[int] = DILATIONS, f32_storage: bool = False,
              x2: bool = False, mask_edges: bool = True,
              out_dtype: Optional[torch.dtype] = None,
              packed: Optional[PackedMRF] = None) -> torch.Tensor:
    """One fused MRF stage over ``x (B, T, C)`` (port of ``fused_mrf_stage_packed``).

    Modes as the JAX function's: bf16 ``x`` alone -> BF16; with
    ``f32_storage`` -> F32_STORAGE; f32 ``x`` or ``x2`` -> F32. Output f32
    except in BF16 mode. Weights are rounded to ``x.dtype`` as JAX rounds them.

    The A/B variants' options: ``mask_edges=False`` drops the zeroing outside
    ``[0, T)`` after each conv, and ``out_dtype=torch.bfloat16`` rounds the
    F32_STORAGE result to bf16 (any other ``out_dtype`` must be the mode's own).

    On the card a bf16 ``x`` (bf16-valued weights, every mode) runs on the
    tensor cores; an f32 ``x`` keeps its weights in f32, which a product of
    bf16 pairs does not compute, so that case alone runs the f32 FMA kernel
    (``svt_mrf_stage_fma``, counted as ``mrf_stage_fma``). ``packed``: the
    weights from :func:`pack_mrf_stage` for these branches (a bf16 ``x``
    only), else they are packed on each call."""
    _check_input("mrf_stage", x)
    mode = _mrf_mode(x.dtype, f32_storage, x2)
    own = torch.bfloat16 if mode == BF16 else torch.float32
    if out_dtype not in (None, own) and not (mode == F32_STORAGE
                                             and out_dtype == torch.bfloat16):
        raise ValueError(f"mrf_stage: out_dtype {out_dtype} in a mode whose output is {own} "
                         "(bf16 is an option of f32_storage only)")
    out_bf16 = (out_dtype or own) == torch.bfloat16
    variant = not mask_edges or out_bf16 != (mode == BF16)
    bsz, t, c = x.shape
    _check_branches(branches, kernel_sizes, dilations, c)
    if packed is not None:
        n_w = 2 * len(dilations) * sum(kernel_sizes) * c * c
        _check_packed("mrf_stage", x, x.dtype == torch.bfloat16, packed,
                      (n_w, 2 * len(dilations) * len(branches) * c))
    if x.device.type == "cpu":
        branches = [tuple(_round_to(a, x.dtype) for a in br) for br in branches]
        return mrf_stage_plain(x, branches, kernel_sizes, dilations, mode, mask_edges,
                               out_bf16)

    if c not in MRF_CHANNELS:
        raise ValueError(f"mrf_stage kernel: C={c} not in {MRF_CHANNELS}")
    if bsz > 65535:
        raise ValueError("mrf_stage kernel: batch above 65535")
    x = x.contiguous()
    radius = stage_radius(kernel_sizes, dilations)
    ints = _branch_ints(branches, kernel_sizes, dilations)
    out = torch.empty((bsz, t, c), device=x.device,
                      dtype=torch.bfloat16 if out_bf16 else torch.float32)
    name = "mrf_stage_variant" if variant else "mrf_stage"
    if x.dtype == torch.bfloat16:
        tile = mrf_stage_tile(c, mode, radius)
        w, b = packed or pack_mrf_stage(branches, x.device)
        entry = load_library().svt_mrf_stage
    else:
        tile = pick_tile(lambda tl: 4 * (3 * (tl + 2 * radius) * (c + 1) + tl * c))
        w = _flat_weights(branches, x.device)
        b = _flat_biases(branches, torch.float32, x.device)
        entry = load_library().svt_mrf_stage_fma
        name += "_fma"
    with torch.cuda.device(x.device):
        launch(name, entry, x.data_ptr(), out.data_ptr(), w.data_ptr(), b.data_ptr(), bsz, t,
               c, tile, radius, *ints, mode, int(x.dtype == torch.bfloat16), int(mask_edges),
               int(out_bf16))
    return out


def mrf_stage_unpacked(x: torch.Tensor, branches: List[BranchWeights],
                       kernel_sizes: Sequence[int], dilations: Sequence[int] = DILATIONS,
                       packed: Optional[PackedMRF] = None,
                       f32_storage: bool = False) -> torch.Tensor:
    """One MRF stage over ``x (B, T, C)`` in ``x.dtype`` (port of
    ``fused_mrf_stage``, mrf.py:60-168): BF16 mode for a bf16 ``x`` (one
    rounding after conv plus bias, bf16 leaky and residual, f32 branch mean),
    F32 for an f32 one. Weights are rounded to ``x.dtype``; the output has
    ``x.dtype``. ``f32_storage`` (an f32 ``x``) runs F32_STORAGE mode
    instead, the function of ``mrf_stage_reference(mixed_f32=True)``: weights
    rounded to bf16, each conv operand rounded once to bf16, f32 states,
    residuals, branch sum and output.

    The CUDA kernels run one residual pair of one branch per launch, over
    time tiles with that pair's own halo, so their shared memory fits at
    C = 256. A bf16 ``x`` runs on the tensor cores
    (``csrc/mrf_pair.cu:svt_mrf_stage_unpacked``; ``mma.sync`` at 32
    channels, ``wgmma`` from 64), and so does ``f32_storage`` at 128 and 256
    channels (``svt_mrf_stage_unpacked_f32s``, counted as
    ``mrf_stage_unpacked_f32s``); a plain f32 ``x`` keeps its weights in f32,
    which a product of bf16 pairs does not compute, so it runs the f32 FMA
    kernel (``csrc/mrf_stage_fma.cu:svt_mrf_stage_unpacked_fma``, counted as
    ``mrf_stage_unpacked_fma``). ``packed``: the weights from
    :func:`pack_mrf_stage` for these branches (bf16-valued weights only: a
    bf16 ``x`` or ``f32_storage``), else they are packed on each call."""
    _check_input("mrf_stage_unpacked", x)
    if f32_storage and x.dtype != torch.float32:
        raise TypeError("mrf_stage_unpacked: f32_storage takes an f32 x")
    mode = F32_STORAGE if f32_storage else BF16 if x.dtype == torch.bfloat16 else F32
    wdt = torch.float32 if mode == F32 else torch.bfloat16
    branches = [tuple(_round_to(a, wdt) for a in br) for br in branches]
    bsz, t, c = x.shape
    _check_branches(branches, kernel_sizes, dilations, c)
    if packed is not None:
        n_w = 2 * len(dilations) * sum(kernel_sizes) * c * c
        _check_packed("mrf_stage_unpacked", x, mode != F32, packed,
                      (n_w, 2 * len(dilations) * len(branches) * c))
    if x.device.type == "cpu":
        return mrf_stage_plain(x, branches, kernel_sizes, dilations, mode)

    channels = F32S_CHANNELS if f32_storage else UNPACKED_CHANNELS
    if c not in channels:
        raise ValueError(f"mrf_stage_unpacked kernel: C={c} not in {channels}")
    if bsz > 65535:
        raise ValueError("mrf_stage_unpacked kernel: batch above 65535")
    x = x.contiguous()
    ints = _branch_ints(branches, kernel_sizes, dilations)
    out = torch.empty_like(x)
    n_pairs, n_branches = len(dilations), len(branches)
    # ping-pong branch states and the f32 branch sum: only where the chain needs them
    s0 = torch.empty_like(x) if n_pairs > 1 else out
    s1 = torch.empty_like(x) if n_pairs > 2 else out
    acc = (torch.empty((bsz, t, c), device=x.device, dtype=torch.float32)
           if n_branches > 1 else out)
    if mode != F32:
        tile = unpacked_tile(c, kernel_sizes, dilations)
        w, b = packed or pack_mrf_stage(branches, x.device)
        lib = load_library()
        name, entry = (("mrf_stage_unpacked_f32s", lib.svt_mrf_stage_unpacked_f32s)
                       if f32_storage else ("mrf_stage_unpacked", lib.svt_mrf_stage_unpacked))
    else:
        h = max((k - 1) // 2 for k in kernel_sizes)
        halo = h * max(dilations) + 2 * h  # conv1's operand halo plus conv2's
        tile = pick_tile(lambda tl: 4 * (2 * tl + 2 * halo) * (c + 1))
        w = _flat_weights(branches, x.device)
        b = _flat_biases(branches, x.dtype, x.device)
        name, entry = "mrf_stage_unpacked_fma", load_library().svt_mrf_stage_unpacked_fma
    n = ctypes.c_int(0)  # one kernel per residual pair of each branch
    with torch.cuda.device(x.device):
        launch(name, entry, x.data_ptr(), out.data_ptr(), s0.data_ptr(), s1.data_ptr(),
               acc.data_ptr(), w.data_ptr(), b.data_ptr(), bsz, t, c, tile, *ints,
               ctypes.byref(n), launched=n)
    return out


def up_mrf_stage(u: torch.Tensor, up_weight: torch.Tensor, up_bias: torch.Tensor,
                 up_kernel: int, up_stride: int, up_padding: int,
                 branches: List[BranchWeights], kernel_sizes: Sequence[int],
                 dilations: Sequence[int] = DILATIONS,
                 post_weight: Optional[torch.Tensor] = None,
                 hifi: bool = False, packed: Optional[PackedUpMRF] = None) -> torch.Tensor:
    """lrelu -> ConvTranspose1d -> MRF stage [-> lrelu(0.01) -> conv_post ->
    tanh] over ``u (B, Tu, Cin)`` (port of ``fused_up_mrf_stage``).

    ``up_weight`` is torch's ``(Cin, Cout, k)``; ``post_weight`` torch's
    ``(1, Cout, k_post)``. ``hifi`` (or an f32 ``u``) runs F32 mode with
    weights rounded to bf16 under ``hifi``; a bf16 ``u`` alone runs BF16.
    Returns (B, Tu*s, Cout), or the waveform (B, Tu*s, 1) with ``post_weight``.

    On the card the upsample and the MRF convs run on the tensor cores
    wherever the weights are bf16 values (``hifi``, or a bf16 ``u``); an f32
    ``u`` without ``hifi`` keeps f32 weights, which a product of bf16 pairs
    does not compute, so that case alone runs the f32 FMA kernel
    (``svt_up_mrf_stage_fma``, counted as ``up_mrf_stage_fma``). ``packed``:
    the weights from :func:`pack_up_mrf_stage` for these arguments (bf16-valued
    weights only), else they are packed on each call."""
    _check_input("up_mrf_stage", u)
    mode = F32 if (hifi or u.dtype == torch.float32) else BF16
    wdt = torch.bfloat16 if hifi else u.dtype
    bsz, tu, cin = u.shape
    cout = up_weight.shape[1]
    if tuple(up_weight.shape) != (cin, cout, up_kernel) or up_kernel - 2 * up_padding != up_stride:
        raise ValueError("up_mrf_stage: ConvTranspose1d weight (Cin, Cout, k) with "
                         "k - 2*padding == stride (output length Tu*stride)")
    _check_branches(branches, kernel_sizes, dilations, cout)
    if post_weight is not None and (tuple(post_weight.shape[:2]) != (1, cout)
                                    or post_weight.shape[2] % 2 == 0):
        raise ValueError(f"up_mrf_stage: post weight {tuple(post_weight.shape)}")
    k_post = 0 if post_weight is None else post_weight.shape[2]
    if packed is not None:
        n_w = (up_kernel * cin + 2 * len(dilations) * sum(kernel_sizes) * cout) * cout
        _check_packed("up_mrf_stage", u, wdt == torch.bfloat16, packed,
                      (n_w, cout, 2 * len(dilations) * len(branches) * cout,
                       max(1, k_post * cout)))
    if u.device.type == "cpu":
        return up_mrf_stage_plain(
            u, _round_to(up_weight, wdt), _round_to(up_bias, wdt), up_stride, up_padding,
            [tuple(_round_to(a, wdt) for a in br) for br in branches], kernel_sizes, dilations,
            mode, None if post_weight is None else _round_to(post_weight, wdt))

    if (cin, cout) not in UP_CHANNELS:
        raise ValueError(f"up_mrf_stage kernel: (Cin, Cout)=({cin}, {cout}) not in {UP_CHANNELS}")
    if bsz > 65535:
        raise ValueError("up_mrf_stage kernel: batch above 65535")
    u = u.contiguous()
    p_post = max(0, (k_post - 1) // 2)
    halo = stage_radius(kernel_sizes, dilations) + p_post
    ints = _branch_ints(branches, kernel_sizes, dilations)
    dev = u.device
    t = tu * up_stride
    out_dtype = torch.bfloat16 if mode == BF16 else torch.float32
    out = torch.empty((bsz, t, 1 if k_post else cout), device=dev, dtype=out_dtype)
    geometry = (bsz, tu, cin, cout, up_kernel, up_stride, up_padding)
    tail = (*ints, mode, int(u.dtype == torch.bfloat16))
    if wdt == torch.bfloat16:
        tile = up_mrf_stage_tile(cin, cout, mode, halo, p_post, up_kernel, up_stride)
        w, bup, b, wpost = packed or pack_up_mrf_stage(up_weight, up_bias, up_stride,
                                                       up_padding, branches, post_weight, dev)
        with torch.cuda.device(dev):
            launch("up_mrf_stage", load_library().svt_up_mrf_stage, u.data_ptr(),
                   out.data_ptr(), w.data_ptr(), bup.data_ptr(), b.data_ptr(),
                   wpost.data_ptr(), *geometry, tile, halo, k_post, *tail)
        return out

    def smem(tile):
        rows = tile + 2 * halo
        u_rows = (rows + up_kernel) // up_stride + 2
        if u_rows * (cin + 1) > 2 * rows * (cout + 1):  # u tile aliases two buffers
            return SMEM_LIMIT + 1
        return 4 * (4 * rows * (cout + 1) + (tile + 2 * p_post) * cout)

    tile = pick_tile(smem)
    w = _flat_weights(branches, dev)
    b = _flat_biases(branches, torch.float32, dev)
    bup = up_bias.to(dev, torch.float32).contiguous()
    wpost = (torch.zeros(1, device=dev) if post_weight is None else
             post_weight[0].t().to(dev, torch.float32).contiguous())  # (k_post, Cout)
    wup = up_weight.permute(2, 0, 1).to(dev, torch.float32).contiguous()  # (k, Cin, Cout)
    with torch.cuda.device(dev):
        launch("up_mrf_stage_fma", load_library().svt_up_mrf_stage_fma, u.data_ptr(),
               out.data_ptr(), wup.data_ptr(), bup.data_ptr(), w.data_ptr(), b.data_ptr(),
               wpost.data_ptr(), *geometry, tile, halo, k_post, *tail)
    return out

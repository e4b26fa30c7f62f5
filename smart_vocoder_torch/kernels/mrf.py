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
  ``decoder_apply(pallas_stage2=True)``);
- :func:`up_mrf_stage` replaces ``fused_up_mrf_stage`` (decoder stage 4, or
  stage 3 under ``pallas_stage2``): lrelu -> ConvTranspose1d upsample -> the
  MRF stage, optionally followed by the decoder tail lrelu(0.01) -> conv_post
  -> tanh.

They compute the *function* of the TPU kernels, not their block structure
(space-to-depth packing, per-tap weights and the DMA'd mask are TPU lane
tricks). Each wrapper launches its CUDA kernel (``csrc/mrf_stage.cu``) for a
CUDA tensor, or raises; for a CPU tensor it runs the plain PyTorch version
beside it (:func:`mrf_stage_plain`, :func:`up_mrf_stage_plain`), which the
tests and ``chip_smoke.py`` hold the kernels against. ``mrf_stage_unpacked``
is ``fused_mrf_stage``'s contract, which is the BF16 mode for a bf16 ``x`` and
the F32 mode for an f32 one, so its plain version is ``mrf_stage_plain``.

Precision modes (one int flag of the kernels, mirrored by the plain
versions, which compute in float32 and round explicitly where the JAX
kernels cast):

- ``BF16``: conv operands, every stored intermediate, residual sum and the
  output are bf16 (f32 accumulation); the leaky slope and its product are
  bf16 too, as JAX evaluates ``x * 0.1`` on a bf16 array.
- ``F32_STORAGE``: f32 storage and output, each conv operand rounded once to
  bf16 (``fused_mrf_stage_packed(f32_storage=True)``, hifi levels 1-2).
- ``F32``: no rounding of activations. This is the JAX f32 mode and also its
  ``x2`` / ``hifi`` modes: there the hi+lo bf16 pair reconstructs the f32
  operand to ~2^-16, which an f32 FMA against the bf16-rounded weight computes
  directly.

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
from typing import List, Optional, Sequence, Tuple

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


def _branch_args(branches, kernel_sizes, dilations, device):
    """Flat f32 weights [branch][w1, w2] and biases [branch][b1, b2] + int args."""
    w = torch.cat([torch.cat([w1.reshape(-1), w2.reshape(-1)]) for w1, _, w2, _ in branches])
    b = torch.cat([torch.cat([b1.reshape(-1), b2.reshape(-1)]) for _, b1, _, b2 in branches])
    ks = list(kernel_sizes) + [0] * (3 - len(kernel_sizes))
    ds = list(dilations) + [0] * (3 - len(dilations))
    w = w.to(device=device, dtype=torch.float32).contiguous()
    b = b.to(device=device, dtype=torch.float32).contiguous()
    return w, b, [len(branches), *ks, len(dilations), *ds]


def mrf_stage(x: torch.Tensor, branches: List[BranchWeights], kernel_sizes: Sequence[int],
              dilations: Sequence[int] = DILATIONS, f32_storage: bool = False,
              x2: bool = False, mask_edges: bool = True,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One fused MRF stage over ``x (B, T, C)`` (port of ``fused_mrf_stage_packed``).

    Modes as the JAX function's: bf16 ``x`` alone -> BF16; with
    ``f32_storage`` -> F32_STORAGE; f32 ``x`` or ``x2`` -> F32. Output f32
    except in BF16 mode. Weights are rounded to ``x.dtype`` as JAX rounds them.

    The A/B variants' options: ``mask_edges=False`` drops the zeroing outside
    ``[0, T)`` after each conv, and ``out_dtype=torch.bfloat16`` rounds the
    F32_STORAGE result to bf16 (any other ``out_dtype`` must be the mode's own)."""
    _check_input("mrf_stage", x)
    mode = _mrf_mode(x.dtype, f32_storage, x2)
    own = torch.bfloat16 if mode == BF16 else torch.float32
    if out_dtype not in (None, own) and not (mode == F32_STORAGE
                                             and out_dtype == torch.bfloat16):
        raise ValueError(f"mrf_stage: out_dtype {out_dtype} in a mode whose output is {own} "
                         "(bf16 is an option of f32_storage only)")
    out_bf16 = (out_dtype or own) == torch.bfloat16
    variant = not mask_edges or out_bf16 != (mode == BF16)
    branches = [tuple(_round_to(a, x.dtype) for a in br) for br in branches]
    bsz, t, c = x.shape
    _check_branches(branches, kernel_sizes, dilations, c)
    if x.device.type == "cpu":
        return mrf_stage_plain(x, branches, kernel_sizes, dilations, mode, mask_edges,
                               out_bf16)

    if c not in MRF_CHANNELS:
        raise ValueError(f"mrf_stage kernel: C={c} not in {MRF_CHANNELS}")
    if bsz > 65535:
        raise ValueError("mrf_stage kernel: batch above 65535")
    x = x.contiguous()
    radius = stage_radius(kernel_sizes, dilations)
    tile = pick_tile(lambda tl: 4 * (3 * (tl + 2 * radius) * (c + 1) + tl * c))
    w, b, ints = _branch_args(branches, kernel_sizes, dilations, x.device)
    out = torch.empty((bsz, t, c), device=x.device,
                      dtype=torch.bfloat16 if out_bf16 else torch.float32)
    with torch.cuda.device(x.device):
        launch("mrf_stage_variant" if variant else "mrf_stage", load_library().svt_mrf_stage,
               x.data_ptr(), out.data_ptr(), w.data_ptr(), b.data_ptr(), bsz, t, c, tile,
               radius, *ints, mode, int(x.dtype == torch.bfloat16), int(mask_edges),
               int(out_bf16))
    return out


def mrf_stage_unpacked(x: torch.Tensor, branches: List[BranchWeights],
                       kernel_sizes: Sequence[int],
                       dilations: Sequence[int] = DILATIONS) -> torch.Tensor:
    """One MRF stage over ``x (B, T, C)`` in ``x.dtype`` (port of
    ``fused_mrf_stage``, mrf.py:60-168): BF16 mode for a bf16 ``x`` (one
    rounding after conv plus bias, bf16 leaky and residual, f32 branch mean),
    F32 for an f32 one. Weights are rounded to ``x.dtype``; the output has
    ``x.dtype``.

    The CUDA kernel runs one residual pair of one branch per launch, over
    time tiles with that pair's own halo, so its shared memory fits at
    C = 256 (``csrc/mrf_stage.cu:svt_mrf_stage_unpacked``)."""
    _check_input("mrf_stage_unpacked", x)
    mode = BF16 if x.dtype == torch.bfloat16 else F32
    branches = [tuple(_round_to(a, x.dtype) for a in br) for br in branches]
    bsz, t, c = x.shape
    _check_branches(branches, kernel_sizes, dilations, c)
    if x.device.type == "cpu":
        return mrf_stage_plain(x, branches, kernel_sizes, dilations, mode)

    if c not in UNPACKED_CHANNELS:
        raise ValueError(f"mrf_stage_unpacked kernel: C={c} not in {UNPACKED_CHANNELS}")
    if bsz > 65535:
        raise ValueError("mrf_stage_unpacked kernel: batch above 65535")
    x = x.contiguous()
    h = max((k - 1) // 2 for k in kernel_sizes)
    halo = h * max(dilations) + 2 * h  # conv1's operand halo plus conv2's
    elt = 2 if mode == BF16 else 4  # shared memory stores the mode's own type
    tile = pick_tile(lambda tl: elt * (2 * tl + 2 * halo) * (c + 1))
    w, b, ints = _branch_args(branches, kernel_sizes, dilations, x.device)
    out = torch.empty_like(x)
    n_pairs, n_branches = len(dilations), len(branches)
    # ping-pong branch states and the f32 branch sum: only where the chain needs them
    s0 = torch.empty_like(x) if n_pairs > 1 else out
    s1 = torch.empty_like(x) if n_pairs > 2 else out
    acc = (torch.empty((bsz, t, c), device=x.device, dtype=torch.float32)
           if n_branches > 1 else out)
    n = ctypes.c_int(0)  # one kernel per residual pair of each branch
    with torch.cuda.device(x.device):
        launch("mrf_stage_unpacked", load_library().svt_mrf_stage_unpacked, x.data_ptr(),
               out.data_ptr(), s0.data_ptr(), s1.data_ptr(), acc.data_ptr(), w.data_ptr(),
               b.data_ptr(), bsz, t, c, tile, *ints, int(mode == BF16), ctypes.byref(n),
               launched=n)
    return out


def up_mrf_stage(u: torch.Tensor, up_weight: torch.Tensor, up_bias: torch.Tensor,
                 up_kernel: int, up_stride: int, up_padding: int,
                 branches: List[BranchWeights], kernel_sizes: Sequence[int],
                 dilations: Sequence[int] = DILATIONS,
                 post_weight: Optional[torch.Tensor] = None,
                 hifi: bool = False) -> torch.Tensor:
    """lrelu -> ConvTranspose1d -> MRF stage [-> lrelu(0.01) -> conv_post ->
    tanh] over ``u (B, Tu, Cin)`` (port of ``fused_up_mrf_stage``).

    ``up_weight`` is torch's ``(Cin, Cout, k)``; ``post_weight`` torch's
    ``(1, Cout, k_post)``. ``hifi`` (or an f32 ``u``) runs F32 mode with
    weights rounded to bf16 under ``hifi``; a bf16 ``u`` alone runs BF16.
    Returns (B, Tu*s, Cout), or the waveform (B, Tu*s, 1) with ``post_weight``."""
    _check_input("up_mrf_stage", u)
    mode = F32 if (hifi or u.dtype == torch.float32) else BF16
    wdt = torch.bfloat16 if hifi else u.dtype
    up_weight, up_bias = _round_to(up_weight, wdt), _round_to(up_bias, wdt)
    branches = [tuple(_round_to(a, wdt) for a in br) for br in branches]
    if post_weight is not None:
        post_weight = _round_to(post_weight, wdt)
    bsz, tu, cin = u.shape
    cout = up_weight.shape[1]
    if tuple(up_weight.shape) != (cin, cout, up_kernel) or up_kernel - 2 * up_padding != up_stride:
        raise ValueError("up_mrf_stage: ConvTranspose1d weight (Cin, Cout, k) with "
                         "k - 2*padding == stride (output length Tu*stride)")
    _check_branches(branches, kernel_sizes, dilations, cout)
    if post_weight is not None and (tuple(post_weight.shape[:2]) != (1, cout)
                                    or post_weight.shape[2] % 2 == 0):
        raise ValueError(f"up_mrf_stage: post weight {tuple(post_weight.shape)}")
    if u.device.type == "cpu":
        return up_mrf_stage_plain(u, up_weight, up_bias, up_stride, up_padding, branches,
                                  kernel_sizes, dilations, mode, post_weight)

    if (cin, cout) not in UP_CHANNELS:
        raise ValueError(f"up_mrf_stage kernel: (Cin, Cout)=({cin}, {cout}) not in {UP_CHANNELS}")
    if bsz > 65535:
        raise ValueError("up_mrf_stage kernel: batch above 65535")
    u = u.contiguous()
    k_post = 0 if post_weight is None else post_weight.shape[2]
    p_post = max(0, (k_post - 1) // 2)
    halo = stage_radius(kernel_sizes, dilations) + p_post

    def smem(tile):
        rows = tile + 2 * halo
        u_rows = (rows + up_kernel) // up_stride + 2
        if u_rows * (cin + 1) > 2 * rows * (cout + 1):  # u tile aliases two buffers
            return SMEM_LIMIT + 1
        return 4 * (4 * rows * (cout + 1) + (tile + 2 * p_post) * cout)

    tile = pick_tile(smem)
    w, b, ints = _branch_args(branches, kernel_sizes, dilations, u.device)
    wup = up_weight.permute(2, 0, 1).to(u.device, torch.float32).contiguous()  # (k, Cin, Cout)
    bup = up_bias.to(u.device, torch.float32).contiguous()
    wpost = (torch.zeros(1, device=u.device) if post_weight is None else
             post_weight[0].t().to(u.device, torch.float32).contiguous())  # (k_post, Cout)
    t = tu * up_stride
    out_dtype = torch.bfloat16 if mode == BF16 else torch.float32
    out = torch.empty((bsz, t, 1 if k_post else cout), device=u.device, dtype=out_dtype)
    with torch.cuda.device(u.device):
        launch("up_mrf_stage", load_library().svt_up_mrf_stage, u.data_ptr(), out.data_ptr(),
               wup.data_ptr(), bup.data_ptr(), w.data_ptr(), b.data_ptr(), wpost.data_ptr(),
               bsz, tu, cin, cout, up_kernel, up_stride, up_padding, tile, halo, k_post,
               *ints, mode, int(u.dtype == torch.bfloat16))
    return out

"""Fused multi-receptive-field (MRF) decoder stages: CUDA kernels + plain versions.

One HiFi-GAN MRF stage is the mean over the ResBlock1 branches; the branch
with kernel size k runs the residual pairs ``x += c2(lrelu(c1_d(lrelu(x))))``
for dilations d in (1, 3, 5) -- 18 convolutions for the 3 branches. Every
intermediate is zeroed outside the real sequence ``[0, T)`` (the zero padding
torch gives each conv at the true boundary).

Two kernels, counterparts of the JAX package's Pallas kernels:

- :func:`mrf_stage` replaces ``smart_vocoder_tpu/kernels/mrf.py:
  fused_mrf_stage_packed`` (decoder stage 3);
- :func:`up_mrf_stage` replaces ``fused_up_mrf_stage`` (decoder stage 4):
  lrelu -> ConvTranspose1d upsample -> the MRF stage, optionally followed by
  the decoder tail lrelu(0.01) -> conv_post -> tanh.

They compute the *function* of the TPU kernels, not their block structure
(space-to-depth packing, per-tap weights and the DMA'd mask are TPU lane
tricks). Each wrapper launches its CUDA kernel (``csrc/mrf_stage.cu``) for a
CUDA tensor, or raises; for a CPU tensor it runs the plain PyTorch version
beside it (:func:`mrf_stage_plain`, :func:`up_mrf_stage_plain`), which the
tests and ``chip_smoke.py`` hold the kernels against.

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
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1
POST_SLOPE = 0.01  # decoder tail: torch's default leaky_relu slope (models.py:156)
DILATIONS = (1, 3, 5)

BF16, F32_STORAGE, F32 = 0, 1, 2

BranchWeights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# (w1 (n_pairs, k, C, C) [tap, in, out], b1 (n_pairs, C), w2 (same), b2 (same))

# Launches of each CUDA kernel, counted by its wrapper where it launches.
LAUNCHES: Dict[str, int] = {"mrf_stage": 0, "up_mrf_stage": 0}

_SMEM_LIMIT = 232448  # bytes of dynamic shared memory a Hopper block may use
MRF_CHANNELS = (32, 64)  # the kernels are instantiated for these channel counts
UP_CHANNELS = ((64, 32),)  # (Cin, Cout)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
               dilations, mode: int) -> torch.Tensor:
    """f32 (B, C, T) stage input -> f32 mean of the branch outputs."""
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
                    kernel_sizes: Sequence[int], dilations: Sequence[int], mode: int
                    ) -> torch.Tensor:
    """Plain version of :func:`mrf_stage`: x (B, T, C) -> (B, T, C), bf16 in
    BF16 mode, else f32. Weights already rounded by the caller."""
    y = _mrf_chain(x.float().transpose(1, 2), branches, kernel_sizes, dilations, mode)
    y = y.transpose(1, 2)
    return y.to(torch.bfloat16) if mode == BF16 else y.contiguous()


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


def _pick_tile(smem_bytes) -> int:
    for tile in (256, 128, 64, 32):
        if smem_bytes(tile) <= _SMEM_LIMIT:
            return tile
    raise ValueError("stage does not fit in shared memory at any tile size")


def _stream() -> ctypes.c_void_p:
    """PyTorch's current stream on the current device, for the launch."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def mrf_stage(x: torch.Tensor, branches: List[BranchWeights], kernel_sizes: Sequence[int],
              dilations: Sequence[int] = DILATIONS, f32_storage: bool = False,
              x2: bool = False) -> torch.Tensor:
    """One fused MRF stage over ``x (B, T, C)`` (port of ``fused_mrf_stage_packed``).

    Modes as the JAX function's: bf16 ``x`` alone -> BF16; with
    ``f32_storage`` -> F32_STORAGE; f32 ``x`` or ``x2`` -> F32. Output f32
    except in BF16 mode. Weights are rounded to ``x.dtype`` as JAX rounds them."""
    _check_input("mrf_stage", x)
    mode = _mrf_mode(x.dtype, f32_storage, x2)
    branches = [tuple(_round_to(a, x.dtype) for a in br) for br in branches]
    bsz, t, c = x.shape
    _check_branches(branches, kernel_sizes, dilations, c)
    if x.device.type == "cpu":
        return mrf_stage_plain(x, branches, kernel_sizes, dilations, mode)

    from smart_vocoder_torch.kernels._build import load_library

    if c not in MRF_CHANNELS:
        raise ValueError(f"mrf_stage kernel: C={c} not in {MRF_CHANNELS}")
    if bsz > 65535:
        raise ValueError("mrf_stage kernel: batch above 65535")
    x = x.contiguous()
    radius = stage_radius(kernel_sizes, dilations)
    tile = _pick_tile(lambda tl: 4 * (3 * (tl + 2 * radius) * (c + 1) + tl * c))
    w, b, ints = _branch_args(branches, kernel_sizes, dilations, x.device)
    out = torch.empty((bsz, t, c), device=x.device,
                      dtype=torch.bfloat16 if mode == BF16 else torch.float32)
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.svt_mrf_stage(x.data_ptr(), out.data_ptr(), w.data_ptr(), b.data_ptr(),
                               bsz, t, c, tile, radius, *ints, mode,
                               int(x.dtype == torch.bfloat16), _stream())
    _raise_on(rc, "mrf_stage")
    LAUNCHES["mrf_stage"] += 1
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

    from smart_vocoder_torch.kernels._build import load_library

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
            return _SMEM_LIMIT + 1
        return 4 * (4 * rows * (cout + 1) + (tile + 2 * p_post) * cout)

    tile = _pick_tile(smem)
    w, b, ints = _branch_args(branches, kernel_sizes, dilations, u.device)
    wup = up_weight.permute(2, 0, 1).to(u.device, torch.float32).contiguous()  # (k, Cin, Cout)
    bup = up_bias.to(u.device, torch.float32).contiguous()
    wpost = (torch.zeros(1, device=u.device) if post_weight is None else
             post_weight[0].t().to(u.device, torch.float32).contiguous())  # (k_post, Cout)
    t = tu * up_stride
    out_dtype = torch.bfloat16 if mode == BF16 else torch.float32
    out = torch.empty((bsz, t, 1 if k_post else cout), device=u.device, dtype=out_dtype)
    lib = load_library()
    with torch.cuda.device(u.device):
        rc = lib.svt_up_mrf_stage(u.data_ptr(), out.data_ptr(), wup.data_ptr(),
                                  bup.data_ptr(), w.data_ptr(), b.data_ptr(), wpost.data_ptr(),
                                  bsz, tu, cin, cout, up_kernel, up_stride, up_padding,
                                  tile, halo, k_post, *ints, mode,
                                  int(u.dtype == torch.bfloat16), _stream())
    _raise_on(rc, "up_mrf_stage")
    LAUNCHES["up_mrf_stage"] += 1
    return out

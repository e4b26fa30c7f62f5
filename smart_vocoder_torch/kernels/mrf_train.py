"""The MRF stage with a hand-written backward (the training-path kernel).

Counterpart of ``smart_vocoder_tpu/kernels/mrf_train.py``:

- :func:`mrf_branch_bwd` replaces ``mrf_branch_bwd`` (``_branch_bwd_kernel``):
  the gradients of one ResBlock1 branch chain at ``x`` with output cotangent
  ``g`` -- ``dx`` in ``x.dtype`` and ``(dw1, db1, dw2, db2)`` accumulated in
  f32. On a CUDA tensor it launches its kernels or raises: a bf16 ``x`` the
  tensor-core backward of ``csrc/mrf_train.cu`` (the replay on the unpacked
  stage's pair kernel, the dx step of each pair, one weight-gradient GEMM
  over the time axis: ``2 n_pairs + 1`` launches), an f32 ``x``, whose
  operands are not bf16 values, the FMA body of ``csrc/mrf_train_fma.cu``
  (``2 n_pairs`` launches, counted as ``mrf_branch_bwd_fma``). On a CPU
  tensor it runs :func:`mrf_branch_bwd_plain`, which is written as the
  kernels' pieces: :func:`branch_replay_plain`, :func:`pair_dx_plain` and
  :func:`conv_dw_plain`.
- :class:`MrfStageTrain` / :func:`mrf_stage_train` replace the ``custom_vjp``
  ``mrf_stage_train``: forward ``mrf_stage_unpacked`` (``fused_mrf_stage``),
  residuals ``(x, branches)`` only, backward one :func:`mrf_branch_bwd` per
  branch on ``g / n_branches``, ``dx`` summed over the branches in ``x.dtype``
  and the weight gradients cast to the weights' dtypes.

The backward replays the chain, so nothing but ``x`` and the weights is kept
between forward and backward. Rounding for a bf16 ``x`` follows the TPU
kernel's casts: each replayed conv output, ``dq`` and ``dp`` (the convs with the
tap-flipped, transposed weights), ``dq * dlrelu(h)`` and ``dxb + dp * dlrelu(x)``
are bf16; the weight-gradient products take those bf16 values and sum in f32.
``dlrelu(v)`` is 1 for ``v > 0``, else the slope: ``v == 0`` takes the slope.

That derivative jumps at 0, so two correct backward implementations whose
replays differ in the last bit can disagree by a whole gradient term where a
replayed value lies within rounding noise of 0. To compare them entry by
entry, :func:`mrf_branch_bwd` can return its replay (``with_replay``) and
:func:`mrf_branch_bwd_plain` can take one (``replay``): the replay is then
held to :func:`branch_replay_plain`, and the backward to the plain backward
on the same replay.

It is wired into no train step, as in the JAX package;
``tools/ab_mrf_train.py`` times it against cuDNN autograd.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from smart_vocoder_torch.kernels._build import SMEM_LIMIT, launch, load_library, pick_tile
from smart_vocoder_torch.kernels.mrf import (
    BF16,
    DILATIONS,
    F32,
    LRELU_SLOPE,
    MMA_PAD,
    PAIR_TILES,
    UNPACKED_CHANNELS,
    BranchWeights,
    _bf16_value,
    _check_branches,
    _check_input,
    _leaky,
    _round_to,
    _store,
    mrf_stage_unpacked,
    pack_mrf_weights,
    pair_geometry,
    unpacked_tile,
)

BranchGrads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# (dw1 (n_pairs, k, C, C), db1 (n_pairs, C), dw2, db2), float32
Replay = Tuple[List[torch.Tensor], List[torch.Tensor]]
# (x_0 .. x_{n-1}, h_0 .. h_{n-1}): each pair's input and masked conv1 output, (B, T, C)


def branch_bwd_halo(k: int, dilations: Sequence[int] = DILATIONS) -> int:
    """Rows of x and g beyond a tile that a whole-branch backward over that
    tile reads (mrf_train.py:80): the replay's consumption and the backward's
    add. 22, 66, 110 for k = 3, 7, 11 at dilations (1, 3, 5). The CUDA backward
    works pair by pair and needs only ``(k - 1) // 2 * (d + 1)`` rows per
    launch; this function states the whole-branch figure of the contract."""
    r2 = (k - 1) // 2
    r1 = [r2 * d for d in dilations]
    h = 0
    for j in range(len(dilations)):
        needed_j = sum(r1[i] + r2 for i in range(j))
        f_j = needed_j + r1[j]
        h = max(h, f_j + needed_j + r1[j], f_j + r2)
    return h


def _dleaky(v: torch.Tensor, mode: int) -> torch.Tensor:
    slope = _bf16_value(LRELU_SLOPE) if mode == BF16 else LRELU_SLOPE
    return torch.where(v > 0, 1.0, slope)


def _flip_oik(w: torch.Tensor) -> torch.Tensor:
    """(k, in, out) conv weight -> ``F.conv1d`` weight of its input gradient:
    taps flipped, in/out swapped (mrf_train.py:219)."""
    return w.flip(0).permute(1, 2, 0)


def _conv(v: torch.Tensor, w_oik: torch.Tensor, b, k: int, d: int, mode: int) -> torch.Tensor:
    return _store(F.conv1d(v, w_oik, b, padding=(k - 1) // 2 * d, dilation=d), mode)


def _mode(x: torch.Tensor) -> int:
    return BF16 if x.dtype == torch.bfloat16 else F32


def _replay(x: torch.Tensor, branch: BranchWeights, k: int, dilations, mode: int):
    """The chain replayed in f32 (B, C, T) with the mode's rounding: (xs, hs)."""
    w1, b1, w2, b2 = branch
    xs, hs = [], []
    xb = x.float().transpose(1, 2)
    for j, d in enumerate(dilations):
        xs.append(xb)
        hs.append(_conv(_leaky(xb, LRELU_SLOPE, mode), w1[j].permute(2, 1, 0), b1[j], k, d,
                        mode))
        y = _conv(_leaky(hs[j], LRELU_SLOPE, mode), w2[j].permute(2, 1, 0), b2[j], k, 1, mode)
        xb = _store(y + xb, mode)
    return xs, hs


def branch_replay_plain(x: torch.Tensor, branch: BranchWeights, k: int,
                        dilations: Sequence[int] = DILATIONS) -> Replay:
    """Plain version of the backward's replay: every pair's input ``x_j`` and
    masked conv1 output ``h_j``, (B, T, C) in ``x.dtype``."""
    xs, hs = _replay(x, tuple(_round_to(a, x.dtype) for a in branch), k, dilations, _mode(x))
    return tuple([v.transpose(1, 2).to(x.dtype).contiguous() for v in vs] for vs in (xs, hs))


def _bct(v: torch.Tensor) -> torch.Tensor:
    return v.float().transpose(1, 2)


def _btc(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return v.transpose(1, 2).to(dtype).contiguous()


def pair_dx_plain(dy: torch.Tensor, xj: torch.Tensor, hj: torch.Tensor, w1: torch.Tensor,
                  w2: torch.Tensor, k: int, d: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dx step of one residual pair (``csrc/mrf_train.cu:
    mrf_pair_bwd_kernel``): from the cotangent ``dy`` of ``x_{j+1}``, the pair's
    input ``xj``, its conv1 output ``hj`` ((B, T, C) in one dtype, whose mode
    they take) and its weights ``w1``, ``w2`` ((k, C, C) [tap, in, out], rounded
    to that dtype), ``(dx_j, dh)``: the cotangent of ``x_j`` and ``dh =
    dq * dlrelu(h_j)``, both in that dtype, with the kernel's rounding points."""
    mode = _mode(dy)
    dxb, xb, hb = _bct(dy), _bct(xj), _bct(hj)
    dh = _store(_conv(dxb, _flip_oik(w2), None, k, 1, mode) * _dleaky(hb, mode), mode)
    dp = _conv(dh, _flip_oik(w1), None, k, d, mode)
    dx = _store(dxb + _store(dp * _dleaky(xb, mode), mode), mode)
    return _btc(dx, dy.dtype), _btc(dh, dy.dtype)


def conv_dw_plain(a: torch.Tensor, grad: torch.Tensor, k: int,
                  dil: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of one conv of the weight-gradient GEMM (``csrc/
    mrf_train.cu:mrf_dw_mma_kernel``): over (B, T, C) tensors of one dtype, the
    conv's input ``a`` before its leaky relu and its output cotangent ``grad``,
    ``dw[t][ci][co] = sum_{b, r} lrelu(a)[b, r + (t - r2) dil, ci] *
    grad[b, r, co]`` (rows outside [0, T) are zero) and ``db = sum grad``, in
    f32."""
    r2, t = (k - 1) // 2, a.shape[1]
    padded = F.pad(_leaky(_bct(a), LRELU_SLOPE, _mode(a)), (r2 * dil, r2 * dil))
    g = _bct(grad)
    dw = torch.stack([torch.einsum("bir,bor->io", padded[..., i * dil:i * dil + t], g)
                      for i in range(k)])
    return dw, g.sum((0, 2))


def mrf_branch_bwd_plain(x: torch.Tensor, g: torch.Tensor, branch: BranchWeights, k: int,
                         dilations: Sequence[int] = DILATIONS, replay: Replay | None = None
                         ) -> Tuple[torch.Tensor, BranchGrads]:
    """Plain version of :func:`mrf_branch_bwd`, written out conv by conv in
    f32 with the kernel's rounding points (not ``torch.autograd``, which
    rounds no intermediate and splits the gradient at x == 0), as the CUDA
    backward's pieces: the replay, then for each pair from the last the
    weight gradients of conv2, the dx step and those of conv1. With
    ``replay`` it backpropagates through that replay instead of its own."""
    branch = tuple(_round_to(a, x.dtype) for a in branch)
    w1, _, w2, _ = branch
    xs, hs = branch_replay_plain(x, branch, k, dilations) if replay is None else (
        [v.to(x.dtype) for v in vs] for vs in replay)
    dxb = g.to(x.dtype)
    dw1, db1, dw2, db2 = ([None] * len(dilations) for _ in range(4))
    for j in reversed(range(len(dilations))):
        dw2[j], db2[j] = conv_dw_plain(hs[j], dxb, k, 1)
        dxb, dh = pair_dx_plain(dxb, xs[j], hs[j], w1[j], w2[j], k, dilations[j])
        dw1[j], db1[j] = conv_dw_plain(xs[j], dh, k, dilations[j])
    return dxb.contiguous(), (torch.stack(dw1), torch.stack(db1), torch.stack(dw2),
                              torch.stack(db2))


# The tensor-core backward's geometry, mirrored from csrc/mrf_train.cu.
def branch_bwd_smem_bytes(c: int, tile: int, h: int, d: int) -> int:
    """Shared memory of one block of the dx step (``csrc/mrf_train.cu:
    bwd_smem_bytes``) for a pair of radius h and dilation d: dy over tile +
    2(h*d + h) rows, dh over tile + 2 h*d, bf16 with padded rows, and the
    unpacked stage's ring of weight tiles."""
    rows = 64 if c >= 128 else c
    return ((2 * tile + 2 * (h * d + h) + 2 * h * d) * (c + MMA_PAD) * 2
            + pair_geometry(c).stages * rows * (c + MMA_PAD) * 2)


def branch_bwd_tile(c: int, k: int, dilations: Sequence[int]) -> int:
    """The time tile of the dx step: the largest of ``PAIR_TILES`` whose every
    pair fits in a block's shared memory and whose dq rows, tile + 2 h*d, the
    block's warpgroups cover (64 rows each). (240 at C <= 128 and k = 3, 128
    at k = 7, 11; 64 at C = 256.)"""
    h = (k - 1) // 2
    for tile in PAIR_TILES:
        if all(tile + 2 * h * d <= pair_geometry(c).threads // 2
               and branch_bwd_smem_bytes(c, tile, h, d) <= SMEM_LIMIT for d in dilations):
            return tile
    raise ValueError("mrf_branch_bwd: the dx step does not fit in shared memory")


class DwGeometry(NamedTuple):
    """The weight-gradient GEMM's block (``csrc/mrf_train.cu:DwGeometry``): a
    ``tm`` x ``tm`` output tile of one tap, chunks of ``kc`` rows, a ring of
    ``stages`` chunks."""
    tm: int
    kc: int
    stages: int


def dw_geometry(c: int) -> DwGeometry:
    return DwGeometry(64, 64, 3) if c >= 64 else DwGeometry(32, 128, 3)


def dw_smem_bytes(c: int) -> int:
    """A block's ring: each slot an operand and a grad chunk of kc padded rows."""
    g = dw_geometry(c)
    return g.stages * 2 * g.kc * (g.tm + MMA_PAD) * 2


DW_BLOCKS_PER_SM = 8  # two waves of the four blocks an SM holds (three at C = 32)
DW_MIN_CHUNKS = 4  # chunks a block runs at least, so its ring fills


def dw_splits(rows: int, c: int, k: int, n_convs: int, sms: int = 132) -> int:
    """K ranges of the weight-gradient launch over ``rows`` = B * T: enough
    blocks of (conv, tap, output tile, range) for ``DW_BLOCKS_PER_SM`` on each
    of ``sms`` SMs, each range at least ``DW_MIN_CHUNKS`` chunks long."""
    g = dw_geometry(c)
    per_split = n_convs * k * (c // g.tm) ** 2
    chunks = -(-rows // g.kc)
    return max(1, min(-(-DW_BLOCKS_PER_SM * sms // per_split), chunks // DW_MIN_CHUNKS))


def _flip_weights(w: torch.Tensor) -> torch.Tensor:
    """(n, k, in, out) conv weights -> those of their input gradients as
    same-form convs: taps flipped, in and out swapped."""
    return w.flip(1).transpose(-1, -2)


def pack_branch_weights(branch: BranchWeights, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 tiles of the tensor-core backward (:func:`pack_mrf_weights`'
    layout): the replay's [pair][conv1, conv2] and the dx step's
    [pair][flip(w2)^T, flip(w1)^T], in the order each launch consumes them."""
    w1, _, w2, _ = branch
    return (pack_mrf_weights([branch], device),
            pack_mrf_weights([(_flip_weights(w2), None, _flip_weights(w1), None)], device))


def mrf_branch_bwd(x: torch.Tensor, g: torch.Tensor, branch: BranchWeights, k: int,
                   dilations: Sequence[int] = DILATIONS, with_replay: bool = False):
    """Gradients of one ResBlock1 branch chain at ``x (B, T, C)`` with output
    cotangent ``g``: ``(dx, (dw1, db1, dw2, db2))``, ``dx`` in ``x.dtype``, the
    weight gradients in f32. Weights are rounded to ``x.dtype`` and ``g`` cast to
    it, as the JAX function does. ``with_replay`` appends the replay the
    backward went through, ``(xs, hs)``, for a comparison on equal terms.

    On the card a bf16 ``x`` runs the tensor-core kernels
    (``csrc/mrf_train.cu``) and an f32 ``x`` the FMA body
    (``csrc/mrf_train_fma.cu``). Both add the blocks' partial weight gradients
    with f32 atomics, so dw/db repeat only to f32 summation order from run to
    run."""
    _check_input("mrf_branch_bwd", x)
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"mrf_branch_bwd: g {tuple(g.shape)} on {g.device} does not match "
                         f"x {tuple(x.shape)} on {x.device}")
    bsz, t, c = x.shape
    _check_branches([branch], [k], dilations, c)
    if x.device.type == "cpu":
        out = mrf_branch_bwd_plain(x, g, branch, k, dilations)
        return out + (branch_replay_plain(x, branch, k, dilations),) if with_replay else out

    if c not in UNPACKED_CHANNELS:
        raise ValueError(f"mrf_branch_bwd kernel: C={c} not in {UNPACKED_CHANNELS}")
    if bsz > 65535:
        raise ValueError("mrf_branch_bwd kernel: batch above 65535")
    bf16 = x.dtype == torch.bfloat16
    x, g = x.contiguous(), g.to(x.dtype).contiguous()
    dev, n = x.device, len(dilations)
    branch = tuple(_round_to(a, x.dtype).to(dev).contiguous() for a in branch)
    w1, b1, w2, b2 = branch
    dx = torch.empty_like(x)
    # replayed states x_1 .., conv1 outputs h_0 ..
    xs, hs = (torch.empty((m, bsz, t, c), device=dev, dtype=x.dtype) for m in (max(n - 1, 1), n))
    dw1, dw2 = (torch.zeros((n, k, c, c), device=dev) for _ in range(2))
    db1, db2 = (torch.zeros((n, c), device=dev) for _ in range(2))
    ds = list(dilations) + [0] * (3 - n)
    if bf16:
        # the cotangents of x_1 .., each pair's dh
        dys, dhs = (torch.empty_like(xs), torch.empty_like(hs))
        wf, wb = pack_branch_weights(branch, dev)
        splits = dw_splits(bsz * t, c, k, 2 * n,
                           torch.cuda.get_device_properties(dev).multi_processor_count)
        ptrs = (x, g, dx, xs, hs, dys, dhs, wf, b1, b2, wb, torch.zeros(c, device=dev), dw1,
                db1, dw2, db2)
        ints = (bsz, t, c, unpacked_tile(c, (k,), dilations), branch_bwd_tile(c, k, dilations),
                k, n, *ds, splits)
        name, entry = "mrf_branch_bwd", load_library().svt_mrf_branch_bwd
    else:
        r1, r2 = (k - 1) // 2 * max(dilations), (k - 1) // 2
        tile = pick_tile(lambda tl: 4 * (2 * tl + 2 * (r1 + r2) + 2 * r1) * (c + 1))
        ptrs = (x, g, dx, xs, hs, torch.empty((2, bsz, t, c), device=dev), w1, b1, w2, b2,
                _flip_weights(w1).contiguous(), _flip_weights(w2).contiguous(), dw1, db1, dw2,
                db2)
        ints = (bsz, t, c, tile, k, n, *ds)
        name, entry = "mrf_branch_bwd_fma", load_library().svt_mrf_branch_bwd_fma
    launched = ctypes.c_int(0)  # the entry point's own count of its launches
    with torch.cuda.device(dev):
        launch(name, entry, *(a.data_ptr() for a in ptrs), *ints, ctypes.byref(launched),
               launched=launched)
    if with_replay:
        return dx, (dw1, db1, dw2, db2), ([x, *xs[:n - 1]], list(hs))
    return dx, (dw1, db1, dw2, db2)


class MrfStageTrain(torch.autograd.Function):
    """``mrf_stage_unpacked`` forward, :func:`mrf_branch_bwd` backward.

    ``apply(x, kernel_sizes, dilations, *flat)`` with ``flat`` the branches'
    folded tensors ``w1, b1, w2, b2`` one branch after another ((n_pairs, k,
    C, C) tap/in/out weights, (n_pairs, C) biases); a caller that holds
    ``weight_g`` / ``weight_v`` folds them under autograd."""

    @staticmethod
    def forward(ctx, x, kernel_sizes, dilations, *flat):
        branches = [tuple(flat[i:i + 4]) for i in range(0, len(flat), 4)]
        ctx.kernel_sizes, ctx.dilations = kernel_sizes, dilations
        ctx.save_for_backward(x, *flat)
        return mrf_stage_unpacked(x, branches, kernel_sizes, dilations)

    @staticmethod
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        branches = [tuple(flat[i:i + 4]) for i in range(0, len(flat), 4)]
        # 1 / n_branches in g's own dtype, as the JAX backward scales it (a
        # 0-dim tensor: a Python float would multiply a bf16 g in f32)
        g = g * torch.tensor(1.0 / len(branches), dtype=g.dtype)
        dx, grads = None, []
        for branch, k in zip(branches, ctx.kernel_sizes):
            dxb, dws = mrf_branch_bwd(x, g, branch, k, ctx.dilations)
            dx = dxb if dx is None else dx + dxb
            grads.extend(dw.to(arr.dtype) for dw, arr in zip(dws, branch))
        needs = ctx.needs_input_grad
        return (dx if needs[0] else None, None, None,
                *(gr if need else None for gr, need in zip(grads, needs[3:])))


def mrf_stage_train(x: torch.Tensor, branches: List[BranchWeights],
                    kernel_sizes: Sequence[int],
                    dilations: Sequence[int] = DILATIONS) -> torch.Tensor:
    """One MRF stage over ``x (B, T, C)`` with the hand-written backward:
    the value of ``mrf_stage_unpacked``, differentiable in ``x`` and in every
    branch tensor."""
    flat = [a for br in branches for a in br]
    return MrfStageTrain.apply(x, tuple(kernel_sizes), tuple(dilations), *flat)

"""The MRF stage with a hand-written backward (the training-path kernel).

Counterpart of ``smart_vocoder_tpu/kernels/mrf_train.py``:

- :func:`mrf_branch_bwd` replaces ``mrf_branch_bwd`` (``_branch_bwd_kernel``):
  the gradients of one ResBlock1 branch chain at ``x`` with output cotangent
  ``g`` -- ``dx`` in ``x.dtype`` and ``(dw1, db1, dw2, db2)`` accumulated in
  f32. On a CUDA tensor it launches ``csrc/mrf_train.cu`` or raises; on a CPU
  tensor it runs :func:`mrf_branch_bwd_plain`.
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
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from smart_vocoder_torch.kernels._build import launch, load_library, pick_tile
from smart_vocoder_torch.kernels.mrf import (
    BF16,
    DILATIONS,
    F32,
    LRELU_SLOPE,
    UNPACKED_CHANNELS,
    BranchWeights,
    _bf16_value,
    _check_branches,
    _check_input,
    _leaky,
    _round_to,
    _store,
    mrf_stage_unpacked,
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
    mode = BF16 if x.dtype == torch.bfloat16 else F32
    xs, hs = _replay(x, tuple(_round_to(a, x.dtype) for a in branch), k, dilations, mode)
    return tuple([v.transpose(1, 2).to(x.dtype).contiguous() for v in vs] for vs in (xs, hs))


def mrf_branch_bwd_plain(x: torch.Tensor, g: torch.Tensor, branch: BranchWeights, k: int,
                         dilations: Sequence[int] = DILATIONS, replay: Replay | None = None
                         ) -> Tuple[torch.Tensor, BranchGrads]:
    """Plain version of :func:`mrf_branch_bwd`, written out conv by conv in
    f32 with the kernel's rounding points (not ``torch.autograd``, which
    rounds no intermediate and splits the gradient at x == 0). With
    ``replay`` it backpropagates through that replay instead of its own."""
    mode = BF16 if x.dtype == torch.bfloat16 else F32
    branch = tuple(_round_to(a, x.dtype) for a in branch)
    w1, _, w2, _ = branch
    r2, t = (k - 1) // 2, x.shape[1]
    if replay is None:
        xs, hs = _replay(x, branch, k, dilations, mode)
    else:
        xs, hs = ([v.float().transpose(1, 2) for v in vs] for vs in replay)

    def dw(operand, grad, d):
        """dw[t][ci][co] = sum_{b, r} operand[b, ci, r + (t - r2) d] * grad[b, co, r]."""
        padded = F.pad(operand, (r2 * d, r2 * d))
        return torch.stack([torch.einsum("bir,bor->io", padded[..., i * d:i * d + t], grad)
                            for i in range(k)])

    dxb = g.to(x.dtype).float().transpose(1, 2)
    dw1, db1, dw2, db2 = ([None] * len(dilations) for _ in range(4))
    for j in reversed(range(len(dilations))):
        d = dilations[j]
        dy = dxb
        dw2[j] = dw(_leaky(hs[j], LRELU_SLOPE, mode), dy, 1)
        db2[j] = dy.sum((0, 2))
        dh = _store(_conv(dy, _flip_oik(w2[j]), None, k, 1, mode) * _dleaky(hs[j], mode), mode)
        dw1[j] = dw(_leaky(xs[j], LRELU_SLOPE, mode), dh, d)
        db1[j] = dh.sum((0, 2))
        dp = _conv(dh, _flip_oik(w1[j]), None, k, d, mode)
        dxb = _store(dxb + _store(dp * _dleaky(xs[j], mode), mode), mode)
    dx = dxb.transpose(1, 2).to(x.dtype).contiguous()
    return dx, (torch.stack(dw1), torch.stack(db1), torch.stack(dw2), torch.stack(db2))


def mrf_branch_bwd(x: torch.Tensor, g: torch.Tensor, branch: BranchWeights, k: int,
                   dilations: Sequence[int] = DILATIONS, with_replay: bool = False):
    """Gradients of one ResBlock1 branch chain at ``x (B, T, C)`` with output
    cotangent ``g``: ``(dx, (dw1, db1, dw2, db2))``, ``dx`` in ``x.dtype``, the
    weight gradients in f32. Weights are rounded to ``x.dtype`` and ``g`` cast to
    it, as the JAX function does. ``with_replay`` appends the replay the
    backward went through, ``(xs, hs)``, for a comparison on equal terms.

    The CUDA route adds the blocks' partial weight gradients with f32 atomics,
    so dw/db repeat only to f32 summation order from run to run."""
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
    w1, b1, w2, b2 = (_round_to(a, x.dtype).to(dev).contiguous() for a in branch)
    w1f, w2f = (w.flip(1).transpose(-1, -2).contiguous() for w in (w1, w2))
    r2 = (k - 1) // 2
    r1 = r2 * max(dilations)
    elt = 2 if bf16 else 4  # shared memory stores x's own type
    tile = pick_tile(lambda tl: elt * (2 * tl + 2 * (r1 + r2) + 2 * r1) * (c + 1))
    dx = torch.empty_like(x)
    xs, hs, dtmp = (torch.empty((m, bsz, t, c), device=dev, dtype=x.dtype)
                    for m in (max(n - 1, 1), n, 2))
    dw1, dw2 = (torch.zeros((n, k, c, c), device=dev) for _ in range(2))
    db1, db2 = (torch.zeros((n, c), device=dev) for _ in range(2))
    ds = list(dilations) + [0] * (3 - n)
    launched = ctypes.c_int(0)  # one replay and one backward kernel per residual pair
    with torch.cuda.device(dev):
        launch("mrf_branch_bwd", load_library().svt_mrf_branch_bwd, x.data_ptr(), g.data_ptr(),
               dx.data_ptr(), xs.data_ptr(), hs.data_ptr(), dtmp.data_ptr(), w1.data_ptr(),
               b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), w1f.data_ptr(), w2f.data_ptr(),
               dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), bsz, t, c, tile,
               k, n, *ds, int(bf16), ctypes.byref(launched), launched=launched)
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

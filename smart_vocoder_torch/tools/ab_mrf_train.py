"""Same-process A/B: the MRF stage with the hand-written backward against
cuDNN autograd, at the training shapes.

Counterpart of ``scripts/ab_mrf_train.py``. For each decoder stage's training
shape (B = 16 segment slices of 8192 samples = 32 frames, so (T, C) = (256,
256), (2048, 128), (4096, 64), (8192, 32) for iitp_base) it times forward plus
backward of the scalar ``mean(|stage(x)|)`` (taken in f32) through two legs
that hold the same weight-normed parameters:

  autograd : the training graph's stage -- ``ResBlock1`` modules with weight
             norm, bf16 autocast, ``torch.autograd`` through cuDNN.
  kernel   : ``kernels/mrf_train.mrf_stage_train`` on the weights folded under
             autograd (forward ``mrf_stage_unpacked``, backward the replaying
             ``mrf_branch_bwd`` kernels).

The legs' timing blocks are interleaved (A, B, A, B, ...) and the medians
reported (host clock around steps that end in a synchronize), beside the time
the card is busy in one step of each leg (``torch.profiler``), which says
whether the host's launches or the card bound it, with the difference between the legs' gradients (dx, and the worst
of the weight-norm parameters') and the kernel launches of one step. The
difference is given as the largest entry's, relative to the largest autograd
entry, and as a relative RMS: the cotangent of this loss is sign(y) / N, so
where bf16 rounding flips the sign of one near-zero output a single entry
moves by its full size, which the maximum shows and the RMS does not. It runs on the CUDA card; ``main(device="cpu")``
runs the kernels' plain versions at whatever small size the caller passes.

Usage: python -m smart_vocoder_torch.tools.ab_mrf_train [reps] [iters]
"""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch
from torch import nn

from smart_vocoder_torch.kernels import LAUNCHES, mrf_stage_train
from smart_vocoder_torch.nn.resblock import ResBlock1
from smart_vocoder_torch.tools import device_busy_ms, time_ms
from smart_vocoder_torch.utils.device import resolve_device

KS = (3, 7, 11)
DILS = (1, 3, 5)
B = 16  # configs/iitp_base.json batch_size
SEG_FRAMES = 32  # segment_size 8192 / hop 256
RATES = (8, 8, 2, 2)
SEED = 0


def stage_shapes(seg_frames: int = SEG_FRAMES):
    """(stage, T, channels) of the decoder's MRF stages on one training segment."""
    t, ch = seg_frames, 512
    for i, r in enumerate(RATES):
        t *= r
        ch //= 2
        yield i, t, ch


class Stage(nn.Module):
    """One MRF stage of the training graph over ``x (B, T, C)``: the mean of
    the weight-normed ResBlock1 branches."""

    def __init__(self, ch: int, device: torch.device):
        super().__init__()
        self.resblocks = nn.ModuleList(ResBlock1(ch, k, DILS, weight_norm=True, device=device)
                                       for k in KS)
        gen = torch.Generator().manual_seed(SEED)
        for m in self.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.transpose(1, 2)
        return (sum(blk(xc) for blk in self.resblocks) / len(self.resblocks)).transpose(1, 2)

    def folded_branches(self):
        """The branches as ``mrf_stage_train`` takes them -- (n_pairs, k, C, C)
        tap/in/out weights and (n_pairs, C) biases -- folded from ``weight_g``
        and ``weight_v`` under autograd."""
        def fold(convs):
            return (torch.stack([c.effective_weight().permute(2, 1, 0) for c in convs]),
                    torch.stack([c.bias for c in convs]))

        return [fold(blk.convs1) + fold(blk.convs2) for blk in self.resblocks]


def _rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def _rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def main(reps: int = 3, iters: int = 30, device=None, batch: int = B,
         seg_frames: int = SEG_FRAMES, dtype: torch.dtype = torch.bfloat16) -> list[dict]:
    dev = resolve_device(device)
    rng = np.random.default_rng(SEED)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {where}  B={batch} reps={reps} iters={iters} {dtype}")
    print(f"{'stage':>5} {'T':>6} {'ch':>4} | {'autograd':>9} {'kernel':>8}  (ms/step, fwd+bwd; "
          f"card busy) | "
          f"{'dx max':>8} {'rms':>8} {'dw max':>8} {'rms':>8}  launches per step")
    rows = []
    for i, t, ch in stage_shapes(seg_frames):
        x = torch.from_numpy(rng.normal(0, 1, (batch, t, ch)).astype(np.float32))
        x = x.to(dev, dtype).requires_grad_()
        stage = Stage(ch, dev)
        params = list(stage.parameters())

        def loss_autograd():
            with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=dtype == torch.bfloat16):
                return stage(x).float().abs().mean()

        def loss_kernel():
            return mrf_stage_train(x, stage.folded_branches(), KS, DILS).float().abs().mean()

        def step(loss_fn):
            """Forward and backward; returns (loss, dx, parameter gradients)."""
            x.grad = None
            for p in params:
                p.grad = None
            loss = loss_fn()
            loss.backward()
            return loss, x.grad, [p.grad for p in params]

        legs = {"autograd": loss_autograd, "kernel": loss_kernel}
        loss_a, dx_a, dw_a = step(loss_autograd)
        before = dict(LAUNCHES)
        loss_k, dx_k, dw_k = step(loss_kernel)
        launches = {n: c - before[n] for n, c in LAUNCHES.items() if c != before[n]}
        acc = {n: [] for n in legs}
        for _ in range(reps):
            for n, fn in legs.items():  # interleaved
                acc[n].append(time_ms(lambda: step(fn), iters, dev))
        row = {"stage": i, "t": t, "ch": ch,
               "autograd_ms": statistics.median(acc["autograd"]),
               "kernel_ms": statistics.median(acc["kernel"]),
               "autograd_busy_ms": device_busy_ms(lambda: step(loss_autograd), dev),
               "kernel_busy_ms": device_busy_ms(lambda: step(loss_kernel), dev),
               "loss_autograd": loss_a.item(), "loss_kernel": loss_k.item(),
               "dx_rel_max": _rel_max(dx_k, dx_a), "dx_rel_rms": _rel_rms(dx_k, dx_a),
               "dw_rel_max": max(_rel_max(k, a) for k, a in zip(dw_k, dw_a)),
               "dw_rel_rms": max(_rel_rms(k, a) for k, a in zip(dw_k, dw_a)),
               "launches": launches}
        rows.append(row)
        busy = ("" if dev.type != "cuda" else
                f"({row['autograd_busy_ms']:.2f}, {row['kernel_busy_ms']:.2f})")
        print(f"{i:>5} {t:>6} {ch:>4} | {row['autograd_ms']:>9.2f} {row['kernel_ms']:>8.2f}"
              f"  {busy:>32} | {row['dx_rel_max']:>8.1e} {row['dx_rel_rms']:>8.1e} "
              f"{row['dw_rel_max']:>8.1e} {row['dw_rel_rms']:>8.1e}  {row['launches']}",
              flush=True)
    return rows


if __name__ == "__main__":
    main(*map(int, sys.argv[1:3]))

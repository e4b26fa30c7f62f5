"""The GAN train step (reference train.py:123-213); counterpart of
``smart_vocoder_tpu/training/step.py``, in the same order:

  1. ONE generator forward (posterior -> flow -> random slice -> decode),
     whose graph serves the G phase, as the reference reuses its single
     ``y_hat`` (train.py:150/:185/:200);
  2. the NDA jigsaw negative: 4 time chunks of the real slice permuted,
     ``0.75 * y_hat + 0.25 * y_jigsaw``, detached (train.py:168-185);
  3. the D update on (y, negative): D loss -> D gradients -> their global
     norm, measured before the optional ``train.clip_grad_value`` clamp
     (commons.py:146-161) -> ``opt_d.step()`` (train.py:184-196);
  4. the G update through the *updated* D on (y, y_hat): gen + feature
     matching (real maps detached) + c_mel x mel L1 + c_kl x KL, G
     gradients from the forward of step 1 -> norm -> clamp ->
     ``opt_g.step()`` (train.py:198-213).

D's parameters are frozen through the G phase, so its backward neither
computes nor leaves gradients on them; gradients are taken with
``torch.autograd.grad`` and handed to the optimizer, so neither phase sees the
other's. Under ``use_spectral_norm`` each D forward advances the ``weight_u``
buffers (twice a phase: real and generated run apart).

Compute runs in bf16 when ``tpu.bf16_run`` is set (the convs' weights and
inputs cast at each call, ``nn.set_compute_dtype``) over f32 master weights
and f32 optimizer state, with every loss in f32 and no GradScaler: the JAX
package's ``dtype=bf16`` modules over f32 params (training/loop.py:96-97).

Under ``torch.distributed`` (``parallel/dist.py``) each phase's gradients
are averaged over the ranks with one flat all-reduce before their norm and
clamp, and each rank's KL term is divided by the global mask sum over the
rank count, so the averaged gradient is the global batch's, as under JAX's
``pjit``; the other losses are means over equal per-rank batches. Under a
model axis (``parallel/mesh.py``, ``training/sharded.py``) the norm and the
clamp still see the full averaged gradients; each optimizer then takes
this rank's block of those its rule shards.

Randomness is explicit: the posterior noise ``eps_q`` (B, T, inter), the
slice starts ``ids_slice`` (B,) and the jigsaw permutation ``perm`` (4,) are
passed in, or drawn from a ``torch.Generator`` (the JAX step splits one key,
step.py:137 and synthesizer.py:292).

While a profiler runs, the step records spans (``utils/profiling.py``):
``train.step`` (``step``, ``rows``, ``frames``) around the call, and inside
it ``train.forward`` (steps 1-2, with the batch's copy and the draws),
``train.d_phase`` (step 3) and ``train.g_phase`` (step 4), which tile it but
for the step count and the metrics dict; in each phase ``train.optim``
(``net``: ``d`` or ``g``) around the optimizer's step and ``zero_grad``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import torch

from smart_vocoder_torch import losses as losses_lib
from smart_vocoder_torch.models import build_discriminator, build_synthesizer
from smart_vocoder_torch.nn import set_compute_dtype
from smart_vocoder_torch.ops import MelConfig, mel_spectrogram, slice_segments, spec_to_mel
from smart_vocoder_torch.parallel import dist as dist_lib
from smart_vocoder_torch.parallel.mesh import Mesh
from smart_vocoder_torch.training.optim import make_optimizer
from smart_vocoder_torch.training.sharded import ShardedAdamW
from smart_vocoder_torch.utils.device import resolve_device
from smart_vocoder_torch.utils.init import init_discriminator, init_synthesizer
from smart_vocoder_torch.utils.profiling import span


@dataclasses.dataclass
class Batch:
    """One padded training batch (the JAX package's ``Batch``), time-major."""

    spec: torch.Tensor          # (B, T, n_fft//2+1) float32
    spec_lengths: torch.Tensor  # (B,) int
    wav: torch.Tensor           # (B, T*hop, 1) float32
    wav_lengths: torch.Tensor   # (B,) int
    sid: Optional[torch.Tensor] = None  # (B,) speaker ids (ms configs)

    def _map(self, fn) -> "Batch":
        # field by field: dataclasses.astuple would deep-copy every tensor first
        return Batch(*(None if v is None else fn(v)
                       for v in (getattr(self, f.name) for f in dataclasses.fields(self))))

    def to(self, device, non_blocking: bool = False) -> "Batch":
        return self._map(lambda v: v.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "Batch":
        return self._map(torch.Tensor.pin_memory)


@dataclasses.dataclass
class TrainState:
    """Both nets (f32 parameters), their AdamW optimizers and the step count;
    the step updates it in place."""

    net_g: torch.nn.Module
    net_d: torch.nn.Module
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    step: int = 0


def init_train_state(hps, seed: int = 1234, device=None, net_g=None,
                     net_d=None, mesh: Optional[Mesh] = None) -> TrainState:
    """Both nets on ``device`` (the card unless the caller names another),
    in training mode, computing in the config's dtype, with their optimizers
    (over this rank's share of the parameters where ``mesh`` has a model
    axis). Nets not given are built from the config and seeded: G with the
    plain init (no ``conv_post`` gain, as JAX's ``init_train_state``), D from
    ``seed + 1``."""
    device = resolve_device(device)
    if net_g is None:
        net_g = init_synthesizer(build_synthesizer(hps), seed, conv_post_gain=1.0)
    if net_d is None:
        net_d = init_discriminator(build_discriminator(hps), seed + 1)
    dtype = torch.bfloat16 if hps.tpu.bf16_run else torch.float32
    for net in (net_g, net_d):
        net.to(device).train()
        set_compute_dtype(net, dtype)
    return TrainState(net_g, net_d, make_optimizer(hps, net_g.parameters(), mesh),
                      make_optimizer(hps, net_d.parameters(), mesh))


def nda_jigsaw(y: torch.Tensor, y_hat: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Jigsaw negative (train.py:168-181): ``y (B, seg, 1)`` cut into 4 time
    chunks, permuted by ``perm`` (one for the batch); the identity
    permutation falls back to ``y_hat``. Returns ``0.75 y_hat + 0.25 y_jig``
    (f32 where ``y`` is)."""
    b, seg, _ = y.shape
    perm = perm.to(y.device)
    y_jig = y.reshape(b, 4, seg // 4, 1)[:, perm].reshape(b, seg, 1)
    is_identity = torch.all(perm == torch.arange(4, device=y.device))
    y_jigsaw = torch.where(is_identity, y_hat, y_jig)
    return 0.75 * y_hat + 0.25 * y_jigsaw


@contextlib.contextmanager
def frozen(net: torch.nn.Module):
    """``net``'s parameters out of autograd for the block."""
    params = [p for p in net.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient (optax.global_norm), in
    f32. The sum runs in f64: one f32 reduction over all of G's gradients
    drifts by ~1e-4 of the norm, where optax's per-leaf sums do not."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    return torch.linalg.vector_norm(flat, dtype=torch.float64).float()


def make_train_step(hps, device=None):
    """The step for ``hps`` on ``device`` (the card unless the caller names
    another): ``train_step(state, batch, generator=None, eps_q=None,
    ids_slice=None, perm=None) -> (state, metrics)``. What is not passed is
    drawn from ``generator`` on its device. ``metrics`` holds detached
    tensors under the JAX step's names (step.py:220-238), with the three
    ``image/*`` mels of the first row. Made inside a process group, the step
    is data parallel over it."""
    device = resolve_device(device)
    distributed = dist_lib.active()
    mel_cfg = MelConfig.from_hparams(hps)
    hop = hps.data.hop_length
    seg_frames = hps.train.segment_size // hop
    seg_samples = hps.train.segment_size
    c_mel, c_kl = float(hps.train.c_mel), float(hps.train.c_kl)
    inter = hps.model.inter_channels
    clip_val = hps.train.get("clip_grad_value", None)
    clip_val = float(clip_val) if clip_val is not None else None

    def update(opt, params, loss, net: str) -> torch.Tensor:
        """Gradients of ``loss`` for ``params`` -> their norm before the clamp
        -> optional clamp -> one optimizer step (the span ``train.optim`` of
        ``net``)."""
        grads = torch.autograd.grad(loss, params)
        if distributed:
            grads = dist_lib.average_gradients(grads)
        norm = global_norm(grads)
        if clip_val is not None:
            grads = [g.clamp(-clip_val, clip_val) for g in grads]
        if isinstance(opt, ShardedAdamW):
            opt.take_gradients(grads)
        else:
            for p, g in zip(params, grads):
                p.grad = g
        with span("train.optim", net=net):
            opt.step()
            opt.zero_grad(set_to_none=True)
        return norm.detach()

    def train_step(state: TrainState, batch: Batch, generator: torch.Generator | None = None,
                   eps_q: torch.Tensor | None = None, ids_slice: torch.Tensor | None = None,
                   perm: torch.Tensor | None = None):
        with span("train.step", step=state.step, rows=int(batch.spec.shape[0]),
                  frames=int(batch.spec.shape[1])):
            return phases(state, batch, generator, eps_q, ids_slice, perm)

    def phases(state, batch, generator, eps_q, ids_slice, perm):
        net_g, net_d = state.net_g, state.net_d
        with span("train.forward"):
            batch = batch.to(device)
            b, t = batch.spec.shape[:2]
            gen_device = generator.device if generator is not None else device
            if eps_q is None:
                eps_q = torch.randn((b, t, inter), generator=generator, device=gen_device)
            if perm is None:
                perm = torch.randperm(4, generator=generator, device=gen_device)
            mel = spec_to_mel(batch.spec.float(), mel_cfg)

            # ---- ONE generator forward; its graph serves the G phase --------
            y_hat, ids_slice, _, z_mask, (_, z_p, m_p, logs_p, _, logs_q) = net_g(
                mel, batch.spec_lengths, batch.spec, batch.spec_lengths, eps_q.to(device),
                ids_slice=ids_slice, generator=generator, sid=batch.sid)
            y_mel = slice_segments(mel, ids_slice, seg_frames)
            y = slice_segments(batch.wav, ids_slice * hop, seg_samples)
            y_negative = nda_jigsaw(y, y_hat.detach(), perm)  # train.py:185 .detach()

        # ---- discriminator phase (train.py:184-196) ------------------------
        with span("train.d_phase"):
            d_params = list(net_d.parameters())
            y_d_r, y_d_g, _, _ = net_d(y.transpose(1, 2), y_negative.transpose(1, 2))
            loss_disc, losses_disc_r, losses_disc_g = losses_lib.discriminator_loss(y_d_r,
                                                                                    y_d_g)
            grad_norm_d = update(state.opt_d, d_params, loss_disc, "d")

        # ---- generator phase, through the UPDATED discriminator ------------
        with span("train.g_phase"), frozen(net_d):
            g_params = list(net_g.parameters())
            y_hat_mel = mel_spectrogram(y_hat[..., 0].float(), mel_cfg)
            _, y_d_g, fmap_r, fmap_g = net_d(y.transpose(1, 2), y_hat.transpose(1, 2))
            loss_mel = losses_lib.mel_l1_loss(y_mel, y_hat_mel) * c_mel
            kl_den = None
            if distributed:  # this rank's share of the global mask sum
                kl_den = dist_lib.all_reduce_sum(z_mask.float().sum()) / dist_lib.world_size()
            loss_kl = losses_lib.kl_loss(z_p, logs_q, m_p, logs_p, z_mask, kl_den) * c_kl
            fmap_r = [[f.detach() for f in maps] for maps in fmap_r]  # losses.py:11
            loss_fm = losses_lib.feature_loss(fmap_r, fmap_g)
            loss_gen, losses_gen = losses_lib.generator_loss(y_d_g)
            loss_gen_all = loss_gen + loss_fm + loss_mel + loss_kl
            grad_norm_g = update(state.opt_g, g_params, loss_gen_all, "g")
        state.step += 1

        # scalar names of the reference TB dashboard (train.py:224-229)
        metrics: Dict[str, torch.Tensor] = {
            "loss/g/total": loss_gen_all,
            "loss/d/total": loss_disc,
            "loss/g/fm": loss_fm,
            "loss/g/mel": loss_mel,
            "loss/g/kl": loss_kl,
            "grad_norm_d": grad_norm_d,
            "grad_norm_g": grad_norm_g,
        }
        for name, values in (("loss/g", losses_gen), ("loss/d_r", losses_disc_r),
                             ("loss/d_g", losses_disc_g)):
            for i, v in enumerate(values):
                metrics[f"{name}/{i}"] = v
        metrics["image/slice_mel_org"] = y_mel[0].float()  # train.py:230-239
        metrics["image/slice_mel_gen"] = y_hat_mel[0].float()
        metrics["image/all_mel"] = mel[0].float()
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step

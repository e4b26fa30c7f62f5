"""The training loop: the counterpart of ``smart_vocoder_tpu/training/loop.py``
(reference train.py:52-310), step for step.

- Epochs from the checkpoint's; ``lr_for_epoch`` written into both
  optimizers at each epoch's start.
- Resume from the newest ``G_``/``D_`` pair (``utils/checkpoint.py``) into
  the epoch that was running, skipping the batches it consumed
  (``step - (epoch - 1) * steps_per_epoch``; the sampler's order is seeded
  by the epoch).
- Each step's randomness comes from generators on the step's device, seeded
  from ``(train.seed + 1, step)`` for the jigsaw permutation, which every
  rank shares, and ``(train.seed + 1, step, rank)`` for the posterior noise
  and the slice starts; a resumed run draws what a straight run draws.
- Every ``log_interval`` steps: the metrics averaged over the ranks and read
  to the host (the only reads of the step's tensors), the loss list line
  ``[loss_d, loss_g, fm, mel, kl, step, lr]``, the scalars, ``perf/*`` and
  three mel images under the reference's names.
- Every ``eval_interval`` steps: ``eval/mel_l1`` over ``tpu.eval_samples``
  validation utterances (also written to ``train.log``), then a save.
- Under ``torch.distributed`` only the chief (rank 0) logs, evaluates and
  writes the pairs; every rank restores, and every rank stops unless all of
  them resumed the same step and epoch.
- The ranks form JAX's ``('data', 'model')`` mesh (``parallel/mesh.py``)
  with ``tpu.model_parallel`` ranks on the model axis: each rank trains
  ``train.batch_size / model_parallel`` rows, so a step trains
  ``batch_size × data`` rows as JAX's loop does (``loop.py:79-86``), and the
  optimizers keep each rank's share of the moments. The chief's model group
  gathers them for each save.
"""

from __future__ import annotations

import hashlib
import time
from typing import Optional

import numpy as np
import torch

from smart_vocoder_torch.data import AudioSpecDataset, BucketedLoader, BucketSampler
from smart_vocoder_torch.inference import set_precision_flags
from smart_vocoder_torch.ops import MelConfig, mel_spectrogram, spec_to_mel
from smart_vocoder_torch.parallel import dist as dist_lib
from smart_vocoder_torch.parallel.mesh import Mesh
from smart_vocoder_torch.training.optim import lr_for_epoch, set_learning_rate
from smart_vocoder_torch.training.step import init_train_state, make_train_step
from smart_vocoder_torch.utils import logging_utils
from smart_vocoder_torch.utils.checkpoint import CheckpointManager, try_resume
from smart_vocoder_torch.utils.device import resolve_device
from smart_vocoder_torch.utils.profiling import StepProfiler, StepTimer

LOSS_LINE = ("loss/d/total", "loss/g/total", "loss/g/fm", "loss/g/mel", "loss/g/kl")
EVAL_FRAMES = 1000  # the reference's max_len crop (train.py:273)


def keyed_generator(device: torch.device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from a tuple of integers."""
    digest = hashlib.blake2b(repr(tuple(int(k) for k in key)).encode(), digest_size=8).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest, "little") >> 1)


def run(hps, max_steps: Optional[int] = None, device=None) -> None:
    """Train per the config into ``hps.model_dir`` on ``device`` (the card
    unless the caller names another); the equivalent of train.py's run()
    (train.py:52-120). Inside a process group (``parallel.dist``) every rank
    calls it."""
    mesh = Mesh.build(int(hps.tpu.get("model_parallel", 1)))
    rows = mesh.rows_per_rank(hps.train.batch_size)
    device = resolve_device(device)
    set_precision_flags()
    if hps.tpu.get("debug_nans"):  # fail at the first NaN/Inf a backward makes
        torch.autograd.set_detect_anomaly(True)
    rank, world = dist_lib.rank(), dist_lib.world_size()
    is_chief = rank == 0
    logger = writer = writer_eval = None
    if is_chief:
        logger = logging_utils.get_logger(hps.model_dir)
        writer = logging_utils.make_writer(hps.model_dir)
        writer_eval = logging_utils.make_writer(f"{hps.model_dir}/eval")
        logger.info("summary writer: %s.%s", type(writer).__module__, type(writer).__name__)
        logger.info(hps)
        logging_utils.check_git_hash(hps.model_dir, logger)
        logger.info("data parallel: %s", dist_lib.describe(device))
        logger.info("mesh: %s; %d of each step's %d rows a rank", mesh, rows,
                    hps.train.batch_size * mesh.data)

    use_sid = bool(hps.model.get("use_spk_embed", False)) and hps.data.n_speakers > 0
    cache_specs = bool(hps.tpu.get("cache_specs", False))
    train_dataset = AudioSpecDataset(hps.data.training_files, hps.data, cache_specs=cache_specs)
    train_sampler = BucketSampler(train_dataset.lengths, rows,
                                  list(hps.tpu.bucket_boundaries), num_replicas=world,
                                  rank=rank, shuffle=True)
    train_loader = BucketedLoader(train_dataset, train_sampler, with_sid=use_sid, device=device)
    eval_loader = None
    if is_chief:
        eval_dataset = AudioSpecDataset(hps.data.validation_files, hps.data,
                                        cache_specs=cache_specs)
        eval_sampler = BucketSampler(eval_dataset.lengths, 1, list(hps.tpu.bucket_boundaries),
                                     shuffle=False)
        eval_loader = BucketedLoader(eval_dataset, eval_sampler, with_sid=use_sid,
                                     device=device)

    state = init_train_state(hps, seed=hps.train.seed, device=device, mesh=mesh)
    mngr = CheckpointManager(hps.model_dir, keep=hps.tpu.keep_ckpts)
    state, epoch_start, resumed = try_resume(mngr, state)
    # a rank that read no pair, or another one, would train other weights on the same gradients
    dist_lib.check_same("the resumed (step, epoch, resumed)",
                        (state.step, epoch_start, int(resumed)), device)
    steps_per_epoch = max(1, len(train_loader))
    skip_batches = 0
    if resumed:
        skip_batches = state.step - (epoch_start - 1) * steps_per_epoch
        if not 0 <= skip_batches < steps_per_epoch:
            # the data or config changed since the save: start the next epoch cleanly
            epoch_start, skip_batches = epoch_start + (skip_batches > 0), 0
        if is_chief:
            logger.info("resumed from step %d (epoch %d, batch %d)", state.step, epoch_start,
                        skip_batches)
    step_fn = make_train_step(hps, device)
    mel_cfg = MelConfig.from_hparams(hps)

    def save(step: int, epoch: int, lr: float) -> None:
        if mesh.data_index == 0:  # the chief's model group: its moments are gathered
            mngr.save(step, state, epoch, lr, write=is_chief)
        if is_chief:
            logger.info("Saving model and optimizer state at iteration %d to %s/G_%d.pth (+D)",
                        step, hps.model_dir, step)

    seed = hps.train.seed + 1
    global_step = state.step
    last_saved_step = global_step if resumed else -1  # do not save the resume step again
    timer = StepTimer()
    profiler = StepProfiler(f"{hps.model_dir}/profile",
                            global_step + int(hps.tpu.get("profile_start_step", 10)),
                            int(hps.tpu.get("profile_steps", 0)) if is_chief else 0, device)
    samples_per_step = hps.train.batch_size * mesh.data * hps.train.segment_size
    try:
        for epoch in range(epoch_start, hps.train.epochs + 1):
            train_sampler.set_epoch(epoch)
            lr = lr_for_epoch(hps, epoch)
            set_learning_rate(state.opt_g, lr)
            set_learning_rate(state.opt_d, lr)
            t_epoch = time.time()
            start_batch = skip_batches if epoch == epoch_start else 0
            skip_batches = 0
            for batch_idx, batch in enumerate(train_loader.iter_from(start_batch),
                                              start=start_batch):
                profiler.maybe_start(global_step)
                perm = torch.randperm(4, generator=keyed_generator(device, seed, global_step),
                                      device=device)
                state, metrics = step_fn(state, batch,
                                         generator=keyed_generator(device, seed, global_step,
                                                                   rank),
                                         perm=perm)
                timer.tick()
                profiler.maybe_stop(global_step)

                if global_step % hps.train.log_interval == 0:
                    scalars = dist_lib.mean_scalars(metrics)  # every rank takes part
                    if is_chief:
                        _log_step(hps, logger, writer, metrics, scalars, epoch, batch_idx,
                                  len(train_loader), global_step, lr,
                                  timer.metrics(samples_per_step))

                if global_step % hps.train.eval_interval == 0 and global_step != last_saved_step:
                    if is_chief:
                        _evaluate(hps, state.net_g, eval_loader, mel_cfg, writer_eval,
                                  global_step, logger, device)
                    save(global_step, epoch, lr)
                    last_saved_step = global_step

                global_step += 1
                if max_steps is not None and global_step >= max_steps:
                    if global_step != last_saved_step:
                        save(global_step, epoch, lr)
                    return
            if is_chief:
                logger.info("====> Epoch: %d (%.1fs)", epoch, time.time() - t_epoch)

        if global_step != last_saved_step:
            save(global_step, hps.train.epochs, lr_for_epoch(hps, hps.train.epochs))
    finally:
        profiler.close()
        train_loader.close()
        if is_chief:
            eval_loader.close()
            writer.close()
            writer_eval.close()


def _log_step(hps, logger, writer, metrics, scalars, epoch, batch_idx, n_batches, global_step,
              lr, perf) -> None:
    """The reference's log block (train.py:215-239): progress and the loss
    list in ``train.log``, the scalars and three mel images in the writer."""
    logger.info("Train Epoch: %d [%.0f%%]", epoch, 100.0 * batch_idx / max(1, n_batches))
    logger.info([scalars[k] for k in LOSS_LINE] + [global_step, lr])
    scalars = dict(scalars, learning_rate=lr, **perf)
    # arrays are (T, n_mels), plotted (n_mels, T)
    images = {name: logging_utils.plot_spectrogram_to_numpy(
                  metrics[key].float().cpu().numpy().T)
              for name, key in (("slice/mel_org", "image/slice_mel_org"),
                                ("slice/mel_gen", "image/slice_mel_gen"),
                                ("all/mel", "image/all_mel"))}
    logging_utils.summarize(writer, global_step, scalars=scalars, images=images)


@torch.no_grad()
def _evaluate(hps, net_g, eval_loader, mel_cfg, writer_eval, global_step, logger,
              device, eps: Optional[torch.Tensor] = None) -> None:
    """Eval audio, images and ``eval/mel_l1`` (ref: train.py:251-310;
    ``smart_vocoder_tpu/training/loop.py:_evaluate``): the first
    ``tpu.eval_samples`` validation utterances, each padded or cut to 1000
    frames, the batch filled to that many rows by repeating row 0, each row
    with its own ``sid``; ``SynthesizerTrn.infer`` at noise scale 1.0 with
    ``eps`` (the prior noise, (K, 1000, inter_channels)) from a generator
    seeded 0 unless given. ``eval/mel_l1`` is the mean over the
    real rows of each one's copy-synthesis mel-L1 over its valid frames."""
    n_eval = max(1, int(hps.tpu.get("eval_samples", 8)))
    mels, lens_l, sids, first_batch = [], [], [], None
    batches = eval_loader.iter_from(0)
    try:
        for batch in batches:
            if first_batch is None:
                first_batch = batch
            mels.append(spec_to_mel(batch.spec[:1].float(), mel_cfg))
            lens_l.append(int(batch.spec_lengths[0]))
            if batch.sid is not None:
                sids.append(int(batch.sid[0]))
            if len(mels) >= n_eval:
                break
    finally:
        batches.close()
    if first_batch is None:
        return
    n_real = len(mels)
    rows = [i if i < n_real else 0 for i in range(n_eval)]
    mel = torch.zeros((n_eval, EVAL_FRAMES, mels[0].shape[-1]), device=device)
    for i, r in enumerate(rows):
        t = min(mels[r].shape[1], EVAL_FRAMES)
        mel[i, :t] = mels[r][0, :t]
    lens_np = np.asarray([min(lens_l[r], EVAL_FRAMES) for r in rows], np.int32)
    lens = torch.from_numpy(lens_np).to(device)
    sid = torch.tensor([sids[r] for r in rows], device=device) if sids else None
    if eps is None:
        eps = torch.randn((n_eval, EVAL_FRAMES, hps.model.inter_channels),
                          generator=torch.Generator(device=device).manual_seed(0), device=device)
    y_hat, mask = net_g.infer(mel, lens, eps, noise_scale=1.0, sid=sid)
    y_hat = y_hat.float()
    y_hat_len = int(mask[0].sum()) * hps.data.hop_length
    y_hat_mel = mel_spectrogram(y_hat[..., 0], mel_cfg)
    # the generated mel is one frame shorter than the input's grid: compare the overlap
    per_sample = [
        (y_hat_mel[i, :n] - mel[i, :n]).abs().mean()
        for i, n in ((i, min(int(lens_np[i]), y_hat_mel.shape[1])) for i in range(n_real))]
    mel_l1 = float(torch.stack(per_sample).mean())
    images = {"gen/mel": logging_utils.plot_spectrogram_to_numpy(
        y_hat_mel[0].cpu().numpy().T)}
    audios = {"gen/audio": y_hat[0, :y_hat_len, 0].cpu().numpy()}
    if global_step == 0:
        images["gt/mel"] = logging_utils.plot_spectrogram_to_numpy(mel[0].cpu().numpy().T)
        wav_len = int(first_batch.wav_lengths[0])
        audios["gt/audio"] = first_batch.wav[0, :wav_len, 0].cpu().numpy()
    logging_utils.summarize(writer_eval, global_step, images=images, audios=audios,
                            scalars={"eval/mel_l1": mel_l1},
                            audio_sampling_rate=hps.data.sampling_rate)
    logger.info("eval step %d: mel_l1 %.4f", global_step, mel_l1)

"""The training loop's step: ``make_train_step`` fed by ``BucketedLoader`` over
``AudioSpecDataset`` and ``BucketSampler``, called as ``training/loop.py:run``
calls it (a learning rate an epoch, the permutation and the step's generator
from ``keyed_generator``, no read of the step's tensors between log lines).

Traffic parameters (the traffic file): ``clips_per_bucket`` clips in each of
the configuration's buckets that ``frames`` ``[lo, hi]`` reaches, their
lengths spread evenly over the part of ``[lo, hi]`` the bucket holds, so every
batch has ``batch_size`` distinct clips; ``warmup_epochs`` epochs stepped at
set-up (every bucket shape); ``limits``.

Set-up writes the corpus under ``TMPDIR`` (harmonic tones with vibrato and a
little noise, a frozen copy of the program's ``tools/make_corpus.py``
generator, from the seed; removed at the end), builds the nets from the
benchmark's seeded weights and steps the first epoch. The first
``compare_steps`` of those steps are the ones the reference follows: their G
and D losses, each leaf's first gradient as AdamW got it (its first moment
over ``1 - beta1`` after one step) and each leaf's change over the steps.
The window then steps on through the next epochs until it closes.
"""

from __future__ import annotations

import gc
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
from scipy.io import wavfile

from vocbench import compare, weights
from vocbench.harness import Check, Context, Record, derived_seed, rng
from vocbench.reference import graph
from vocbench.reference import train as ref

COMPARE_STEPS = 3


def corpus_lengths(boundaries: list[int], lo: int, hi: int, per_bucket: int) -> list[int]:
    """``per_bucket`` distinct lengths in each bucket ``(b_i, b_i+1]`` that
    meets ``[lo, hi]``."""
    out = []
    for a, b in zip(boundaries[:-1], boundaries[1:]):
        first, last = max(a + 1, lo), min(b, hi)
        if first > last:
            continue
        if last - first + 1 < per_bucket:
            raise ValueError(f"bucket ({a}, {b}] holds fewer than {per_bucket} lengths")
        out.extend(int(x) for x in np.rint(np.linspace(first, last, per_bucket)))
    return out


def make_clips(ctx: Context, lengths: list[int]) -> list[np.ndarray]:
    """PCM16 clips: a fundamental and its first harmonics with a slow vibrato
    and a little noise (``tools/make_corpus.py``'s generator)."""
    g = rng(ctx.seed, 21)
    sr = int(ctx.config["data"]["sampling_rate"])
    hop = int(ctx.config["data"]["hop_length"])
    clips = []
    for f in g.permutation(np.asarray(lengths)):
        t = np.arange(int(f) * hop) / sr
        f0 = g.uniform(90, 300) * (1 + 0.02 * np.sin(2 * np.pi * g.uniform(3, 6) * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        wav = sum(np.sin(h * phase) / h for h in (1, 2, 3, 4))
        wav = wav / np.abs(wav).max() * 0.5 + g.normal(0, 0.003, wav.shape)
        clips.append((wav * 32767).astype(np.int16))
    return clips


def write_corpus(clips: list[np.ndarray], sr: int, out_dir: str) -> str:
    lines = []
    for i, clip in enumerate(clips):
        path = os.path.join(out_dir, f"clip{i:04d}.wav")
        wavfile.write(path, sr, clip)
        lines.append(path)
    filelist = os.path.join(out_dir, "files.txt")
    with open(filelist, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return filelist


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


class Program:
    """The program's loop state and its feed, stepped as ``loop.run`` steps."""

    def __init__(self, ctx: Context, filelist: str, g_leaves: dict, d_leaves: dict):
        from smart_vocoder_torch.data import AudioSpecDataset, BucketedLoader, BucketSampler
        from smart_vocoder_torch.inference import set_precision_flags
        from smart_vocoder_torch.models import build_discriminator, build_synthesizer
        from smart_vocoder_torch.training.step import init_train_state, make_train_step

        hps = ctx.hps
        hps.data.training_files = filelist
        set_precision_flags()  # as training/loop.py:run does
        self.hps, self.device = hps, ctx.device
        self.use_sid = bool(hps.model.get("use_spk_embed", False)) and hps.data.n_speakers > 0
        self.dataset = AudioSpecDataset(filelist, hps.data,
                                        cache_specs=bool(hps.tpu.get("cache_specs", False)))
        self.sampler = BucketSampler(self.dataset.lengths, hps.train.batch_size,
                                     list(hps.tpu.bucket_boundaries), shuffle=True)
        self.loader = BucketedLoader(self.dataset, self.sampler, with_sid=self.use_sid,
                                     device=ctx.device)
        net_g, net_d = build_synthesizer(hps), build_discriminator(hps)
        net_g.load_state_dict(g_leaves, strict=True)
        net_d.load_state_dict(d_leaves, strict=True)
        self.state = init_train_state(hps, device=ctx.device, net_g=net_g, net_d=net_d)
        self.step_fn = make_train_step(hps, ctx.device)
        self.seed = int(hps.train.seed) + 1
        self.epoch = 0

    def epoch_batches(self):
        """The next epoch: its batches' dataset indices, and an iterator."""
        from smart_vocoder_torch.training.optim import lr_for_epoch, set_learning_rate

        self.epoch += 1
        self.sampler.set_epoch(self.epoch)
        lr = lr_for_epoch(self.hps, self.epoch)
        set_learning_rate(self.state.opt_g, lr)
        set_learning_rate(self.state.opt_d, lr)
        return list(iter(self.sampler)), self.loader.iter_from(0)

    def step(self, batch):
        from smart_vocoder_torch.training.loop import keyed_generator

        s = self.state.step
        perm = torch.randperm(4, generator=keyed_generator(self.device, self.seed, s),
                              device=self.device)
        self.state, metrics = self.step_fn(self.state, batch,
                                           generator=keyed_generator(self.device, self.seed,
                                                                     s, 0), perm=perm)
        return metrics

    def first_gradients(self) -> tuple[dict, dict]:
        """Each leaf's gradient as AdamW got it at the first step: its first
        moment over ``1 - beta1``."""
        out = []
        for net, opt in ((self.state.net_g, self.state.opt_g),
                         (self.state.net_d, self.state.opt_d)):
            beta1 = opt.param_groups[0]["betas"][0]
            out.append({k: opt.state[p]["exp_avg"] / (1.0 - beta1)
                        for k, p in net.named_parameters()})
        return out[0], out[1]

    def close(self):
        self.loader.close()


def run(ctx: Context) -> Record:
    tr, rec, cfg = ctx.traffic, ctx.recorder, ctx.config
    sizes = graph.Sizes.from_config(cfg)
    hop, sr = sizes.hop, int(cfg["data"]["sampling_rate"])
    ctx.hps.train.seed = derived_seed(ctx.seed, 20) % 2 ** 31
    tmp = tempfile.TemporaryDirectory(prefix="vocbench-corpus-")
    try:
        with rec.span("setup.corpus"):
            lengths = corpus_lengths(list(ctx.hps.tpu.bucket_boundaries), *tr["frames"],
                                     int(tr["clips_per_bucket"]))
            clips = make_clips(ctx, lengths)
            filelist = write_corpus(clips, sr, tmp.name)
        with rec.span("setup.weights"):
            gparams, dparams = graph.generator_params(sizes), ref.discriminator_params()
            g0 = weights.make(gparams, derived_seed(ctx.seed, 0), ctx.device, conv_post_gain=1.0,
                              weight_norm=ref.generator_weight_norm(gparams))
            d0 = weights.make(dparams, derived_seed(ctx.seed, 1), ctx.device,
                              weight_norm=ref.discriminator_weight_norm(dparams))
        with rec.span("setup.program"):
            prog = Program(ctx, filelist, g0, d0)
        g0 = {k: v.cpu() for k, v in g0.items()}
        d0 = {k: v.cpu() for k, v in d0.items()}
        seen = warmup(ctx, prog, g0, d0)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
            torch.cuda.reset_peak_memory_stats(ctx.device)
        record = window(ctx, prog, hop, sr)
        record.memory_peak_bytes = (int(torch.cuda.max_memory_allocated(ctx.device))
                                    if ctx.device.type == "cuda" else 0)
        prog.close()
        del prog
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        if record.failed == 0:
            record.checks = check(ctx, sizes, clips, g0, d0, seen)
        return record
    finally:
        tmp.cleanup()


def warmup(ctx: Context, prog: Program, g0: dict, d0: dict) -> dict:
    """``warmup_epochs`` epochs; what the first ``COMPARE_STEPS`` steps read:
    their rows (lengths in batch order) and padded frames, their losses, the
    first gradients' and the change's norms a leaf."""
    seen = {"rows": [], "frames": [], "loss_g": [], "loss_d": []}
    with ctx.recorder.span("setup.warmup"):
        for _ in range(int(ctx.traffic["warmup_epochs"])):
            _, it = prog.epoch_batches()
            for batch in it:
                n = prog.state.step
                metrics = prog.step(batch)
                if n < COMPARE_STEPS:
                    seen["rows"].append(batch.spec_lengths.cpu().tolist())
                    seen["frames"].append(int(batch.spec.shape[1]))
                    seen["loss_g"].append(float(metrics["loss/g/total"]))
                    seen["loss_d"].append(float(metrics["loss/d/total"]))
                if n == 0:
                    gg, gd = prog.first_gradients()
                    seen["grad_g"], seen["grad_d"] = leaf_norms(gg), leaf_norms(gd)
                if n == COMPARE_STEPS - 1:
                    seen["change_g"] = leaf_norms(
                        {k: p.detach().cpu() - g0[k]
                         for k, p in prog.state.net_g.named_parameters()})
                    seen["change_d"] = leaf_norms(
                        {k: p.detach().cpu() - d0[k]
                         for k, p in prog.state.net_d.named_parameters()})
    if len(seen["loss_g"]) < COMPARE_STEPS:
        raise RuntimeError(f"the warm-up made {len(seen['loss_g'])} steps, fewer than "
                           f"{COMPARE_STEPS}")
    return seen


def window(ctx: Context, prog: Program, hop: int, sr: int) -> Record:
    rec = ctx.recorder
    lengths = prog.dataset.lengths
    w = ctx.window()
    attempted = failed = 0
    t0 = w.start()
    setup_s = t0 - ctx.t_process
    try:
        while time.perf_counter() - t0 < ctx.seconds:
            idx, it = prog.epoch_batches()
            for b in idx:
                if time.perf_counter() - t0 >= ctx.seconds:
                    it.close()
                    break
                with rec.span("vb.next"):
                    batch = next(it)
                frames = [int(lengths[i]) for i in b]
                attempted += 1
                with rec.span("vb.step", frames=frames, audio_s=sum(frames) * hop / sr):
                    prog.step(batch)
    except Exception:
        traceback.print_exc(file=sys.stderr)
        failed += 1
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    end = time.perf_counter()
    w.stop()
    return Record(ctx, setup_s, t0, end, attempted, failed, [], 0, w.trace)


def reference_batch(clips_by_len: dict, rows: list[int], frames: int, data: dict, device):
    """The reference's own batch: each row's clip as float, its spectrogram,
    padded to ``frames``."""
    from vocbench.reference import audio

    hop = int(data["hop_length"])
    b = len(rows)
    spec = torch.zeros((b, frames, int(data["filter_length"]) // 2 + 1))
    wav = torch.zeros((b, frames * hop))
    for r, n in enumerate(rows):
        y = torch.from_numpy(clips_by_len[n][: n * hop].astype(np.float32)
                             / np.float32(data["max_wav_value"]))
        spec[r, :n] = audio.spectrogram(y[None], int(data["filter_length"]), hop,
                                        int(data["win_length"]))[0]
        wav[r, : n * hop] = y
    return (spec.to(device), torch.as_tensor(rows, dtype=torch.int64, device=device),
            wav.to(device))


def reference_steps(ctx: Context, sizes, clips, g0, d0, seen, numerics=graph.F32) -> dict:
    """The reference's first steps from the same weights on the same rows."""
    hop = sizes.hop
    clips_by_len = {len(c) // hop: c for c in clips}
    pg = {k: v.to(ctx.device).clone().requires_grad_(True) for k, v in g0.items()}
    pd = {k: v.to(ctx.device).clone().requires_grad_(True) for k, v in d0.items()}
    opt_g, opt_d = ref.make_optimizer(ctx.config, pg), ref.make_optimizer(ctx.config, pd)
    out = {"loss_g": [], "loss_d": []}
    seed = int(ctx.hps.train.seed) + 1
    with compare.reference_precision():
        for n in range(COMPARE_STEPS):
            spec, lens, wav = reference_batch(clips_by_len, seen["rows"][n], seen["frames"][n],
                                              ctx.config["data"], ctx.device)
            o = ref.train_step(pg, pd, opt_g, opt_d, sizes, ctx.config, spec, lens, wav, seed, n,
                               nx=numerics)
            out["loss_g"].append(o.loss_g)
            out["loss_d"].append(o.loss_d)
            if n == 0:
                out["grad_g"], out["grad_d"] = leaf_norms(o.grads_g), leaf_norms(o.grads_d)
    out["change_g"] = leaf_norms({k: v.detach().cpu() - g0[k] for k, v in pg.items()})
    out["change_d"] = leaf_norms({k: v.detach().cpu() - d0[k] for k, v in pd.items()})
    return out


def gaps(got: dict, want: dict) -> dict:
    """The numbers compared: the worst step's relative loss gap (and the
    first step's, ``loss_rel_1``); each leaf's
    gap of first-gradient norms and of change norms (the latter over the
    leaves the reference's gradient moves, at least a thousandth of the
    median leaf's), a leaf's gap taken over the larger of its reference norm
    and the median leaf's; of those, the worst leaf's (``grad_g``) and the
    median leaf's (``grad_g_med``); and the three worst leaves of each, for
    the log."""
    loss = max(abs(a - b) / abs(b) for k in ("loss_g", "loss_d")
               for a, b in zip(got[k], want[k], strict=True))
    first = max(abs(got[k][0] - want[k][0]) / abs(want[k][0]) for k in ("loss_g", "loss_d"))

    def leaf_gaps(a: dict, b: dict, keep=None) -> dict:
        keys = [k for k in b if keep is None or k in keep]
        med = float(np.median([b[k] for k in keys]))
        return {k: abs(a[k] - b[k]) / max(b[k], med, 1e-30) for k in keys}

    out = {"loss_rel": loss, "loss_rel_1": first}
    for net in ("g", "d"):
        grads = want[f"grad_{net}"]
        med = float(np.median(list(grads.values())))
        keep = {k for k, v in grads.items() if v >= 1e-3 * med}
        for what, leaves in (("grad", leaf_gaps(got[f"grad_{net}"], grads)),
                             ("change", leaf_gaps(got[f"change_{net}"], want[f"change_{net}"],
                                                  keep))):
            out[f"{what}_{net}"] = max(leaves.values())
            out[f"{what}_{net}_med"] = float(np.median(list(leaves.values())))
            out[f"{what}_{net}_worst"] = sorted(leaves, key=leaves.get)[-3:][::-1]
        out[f"left_out_{net}"] = len(grads) - len(keep)
    return out


def check(ctx: Context, sizes, clips, g0, d0, seen) -> list[Check]:
    want = reference_steps(ctx, sizes, clips, g0, d0, seen)
    g = gaps(seen, want)
    ctx.log("train: " + ", ".join(f"{k} {v!r}" for k, v in g.items()))
    ctx.log(f"train: program losses g {seen['loss_g']} d {seen['loss_d']}; reference "
            f"g {want['loss_g']} d {want['loss_d']}")
    return [Check(name, float(g[name]), float(limit))
            for name, limit in ctx.traffic["limits"].items()]

"""Headline benchmark: real-time factor of 22.05 kHz mel -> wav synthesis on the card.

Counterpart of the JAX package's root ``bench.py``. It runs the flagship
generator (``configs/iitp_base.json``) on the weights of the fidelity recipe
(``utils/golden.py:fidelity_state_dict``, the JAX ``fidelity_params``) over
B x 1000-frame mels drawn as ``bench.py`` draws them, and prints ONE JSON
line, last, on standard output:

    metric, value, unit        "rtf_22k05_synthesis", seconds of audio a step
                               over the step's seconds, "x_realtime"
    achieved_tflops_per_s, mfu ``utils.flops.synthesis_flops`` over the step,
                               and that over the H100's dense bf16 peak
    mel_l1_vs_reference        the port's f32 ``SynthesizerTrn.infer`` (TF32
                               off) on the fixture's mel and noise against the
                               torch reference's waveform in
                               ``tests/fixtures/golden_iitp_base.npz``
    fidelity_target            1e-2 (``BASELINE.json``)
    mel_l1_serving_<mode>      the same through the exact path that was timed
                               (mode ``hifi``, ``f32`` or ``bf16``)
    rtf_fast_bf16              the hifi-0 path, timed the same way (with hifi on)
    train_step_ms, train_audio_x_realtime, train_mfu_wallclock
                               the bf16 leg of ``tools/bench_train.py`` (B = 16
                               x 1000) in a subprocess
    device, hifi, cudnn_benchmark
                               the card's name and power limit as nvidia-smi
                               gives them, the hifi level timed, and cuDNN's
                               algorithm search as the entry point left it

Timing follows ``bench.py``: ``WARMUP`` calls of ``Vocoder._infer`` on
card-resident mel, lengths and noise (the noise drawn on the card inside the
loop from an explicit generator), then ``iters`` calls and one synchronize;
the mean is reported, and the spread of the calls (CUDA events between them)
goes to standard error with the rest of the log. Numbers are not rounded.

Unlike ``bench.py`` there is no fallback route: a kernel that does not build
or launch ends the run with an error, and so does a kernel route that was
asked for and not taken. ``vs_baseline`` (a TPU v5e target) is left out. A
train phase that fails or times out leaves its three keys out with a log
line, as in ``bench.py``; the serving keys never depend on it. A missing
fixture leaves the fidelity keys out.

Usage: python -m smart_vocoder_torch.bench [--no-kernels] [--wn-kernels] [--f32]
       [--fast] [--no-train] [--batch B] [--iters N] [--config PATH] [--device cpu]
(``--no-kernels``, ``--wn-kernels`` are ``bench.py``'s ``--no-pallas``,
``--pallas-wn``; ``--batch`` and ``--iters`` default to 32 and 30. The train
phase is given ``TRAIN_TIMEOUT`` seconds.)
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from smart_vocoder_torch.config import load_config
from smart_vocoder_torch.inference import Vocoder
from smart_vocoder_torch.kernels import LAUNCHES, reset_launch_counts
from smart_vocoder_torch.ops import MelConfig, mel_spectrogram
from smart_vocoder_torch.utils import jax_random
from smart_vocoder_torch.utils.device import device_label, resolve_device
from smart_vocoder_torch.utils.flops import H100_BF16_PEAK, synthesis_flops
from smart_vocoder_torch.utils.golden import NOISE_SCALE, fidelity_state_dict

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(_ROOT, "configs", "iitp_base.json")
FIXTURE = os.path.join(_ROOT, "tests", "fixtures", "golden_iitp_base.npz")
BATCH = 32
FRAMES = 1000  # ~11.6 s of audio a row at hop 256 / 22.05 kHz
WARMUP = 3
ITERS = 30
NOISE_SEED = 3  # bench.py's jax.random.key(3)
FIDELITY_TARGET = 1e-2
TRAIN_TIMEOUT = 600  # s; the bf16 leg takes ~75 s on an H100


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def timed(vocoder: Vocoder, mel, lens, iters: int, gen: torch.Generator):
    """Mean seconds of one ``_infer`` call over ``iters`` calls after
    ``WARMUP``, the calls' own ms (CUDA events between them on the card, the
    host clock on the CPU), the launches of the first timed call, and the
    last call's output."""
    device = mel.device
    shape = (*mel.shape[:2], vocoder.hps.model.inter_channels)

    def call():
        eps = torch.randn(shape, generator=gen, device=device)
        return vocoder._infer(mel, lens, eps, NOISE_SCALE)

    cuda = device.type == "cuda"
    for _ in range(WARMUP):
        call()
    if cuda:
        torch.cuda.synchronize(device)
    marks = [torch.cuda.Event(enable_timing=True) if cuda else None for _ in range(iters + 1)]
    t0 = time.perf_counter()
    for i in range(iters):
        if cuda:
            marks[i].record()
        else:
            marks[i] = time.perf_counter()
        if i == 0:
            reset_launch_counts()
        out = call()
        if i == 0:
            launches = {k: v for k, v in LAUNCHES.items() if v}
    if cuda:
        marks[iters].record()
        torch.cuda.synchronize(device)
        calls = [marks[i].elapsed_time(marks[i + 1]) for i in range(iters)]
    else:
        marks[iters] = time.perf_counter()
        calls = [(marks[i + 1] - marks[i]) * 1e3 for i in range(iters)]
    return (time.perf_counter() - t0) / iters, calls, launches, out


def golden_case(hps, fixture: str, device: torch.device):
    """The golden fixture on ``device``: ``(mel, lens, eps, noise_scale,
    mel_l1)``, where ``mel_l1(wav)`` is the mean |mel(wav) - mel(wav_ref)|
    of a ``(1, L, 1)`` waveform against the reference's."""
    gz = np.load(fixture)
    mel = torch.from_numpy(gz["mel"]).to(device)
    lens = torch.full((mel.shape[0],), mel.shape[1], dtype=torch.int64, device=device)
    eps = torch.from_numpy(gz["eps"]).to(device)
    mel_cfg = MelConfig.from_hparams(hps)
    ref = mel_spectrogram(torch.from_numpy(gz["wav_ref"])[None].float().to(device), mel_cfg)

    def mel_l1(wav):
        return (mel_spectrogram(wav[..., 0].float(), mel_cfg) - ref).abs().mean().item()

    return mel, lens, eps, float(gz["noise_scale"]), mel_l1


def fidelity_vs_reference(hps, state, vocoder: Vocoder, fixture: str):
    """``(mel_l1_vs_reference, mel_l1_serving)`` against the fixture's
    reference waveform, or ``(None, None)`` where there is no fixture."""
    if not os.path.exists(fixture):
        log(f"fidelity: no golden fixture at {fixture}, skipping")
        return None, None
    device = vocoder.device
    mel, lens, eps, noise_scale, mel_l1 = golden_case(hps, fixture, device)
    # the plain f32 module graph; Vocoder's constructor turns TF32 off
    f32 = Vocoder(hps, state, dtype=torch.float32, use_kernels=False, use_wn_kernels=False,
                  device=device)
    l1 = mel_l1(f32._infer(mel, lens, eps, noise_scale))
    del f32
    l1_serving = mel_l1(vocoder._infer(mel, lens, eps, noise_scale))
    status = "OK" if l1 <= FIDELITY_TARGET else "ABOVE TARGET"
    log(f"mel_l1_vs_reference: {l1:.3e} (f32, TF32 off, target <= {FIDELITY_TARGET:g}: "
        f"{status}); the timed path: {l1_serving:.3e}")
    return l1, l1_serving


def train_metrics(config: str) -> dict:
    """The bf16 leg of ``tools/bench_train.py`` (B = 16 x 1000, its defaults)
    in a bounded subprocess: step ms, audio x real time, and its TFLOP/s over
    the H100's bf16 peak. ``{}`` with a log line on a timeout or a failure."""
    t0 = time.time()
    try:
        p = subprocess.run(
            [sys.executable, "-m", "smart_vocoder_torch.tools.bench_train", "--legs", "bf16",
             "--config", config], capture_output=True, text=True, cwd=_ROOT,
            timeout=TRAIN_TIMEOUT)
    except subprocess.TimeoutExpired:
        log("train phase: timed out; omitting train metrics")
        return {}
    if p.returncode != 0:
        tail = (p.stderr or p.stdout).strip().splitlines()[-1:]
        log(f"train phase failed rc={p.returncode}: {tail}; omitting")
        return {}
    for line in reversed(p.stdout.strip().splitlines()):
        try:
            leg = json.loads(line)["legs"]["bf16"]
        except (json.JSONDecodeError, KeyError, TypeError):
            continue
        mfu = leg["tflops"] * 1e12 / H100_BF16_PEAK
        log(f"train phase ({time.time() - t0:.0f} s): {leg['step_ms']:.2f} ms/step, "
            f"mfu {mfu:.4f}")
        return {"train_step_ms": leg["step_ms"],
                "train_audio_x_realtime": leg["audio_x_realtime"],
                "train_mfu_wallclock": mfu}
    log("train phase: no JSON line found; omitting")
    return {}


def main(device=None, hps=None, config: str = CONFIG, batch: int = BATCH, iters: int = ITERS,
         kernels: bool = True, wn_kernels: bool = False, f32: bool = False, fast: bool = False,
         train: bool = True, fixture: str = FIXTURE) -> dict:
    """Time, check and print the headline; return its JSON object. ``device``
    is the card unless the caller names the CPU; ``hps`` defaults to
    ``config``'s."""
    device = resolve_device(device)
    if iters < 1:
        raise ValueError("iters must be at least 1")
    if hps is None:
        hps = load_config(config)
    dtype = torch.float32 if f32 else torch.bfloat16
    wn_kernels = kernels and wn_kernels
    # the headline is serving-fidelity level 2; --fast, --f32 and --no-kernels time level 0
    hifi = 2 if kernels and dtype == torch.bfloat16 and not fast else 0
    hop, sr = hps.data.hop_length, hps.data.sampling_rate

    t0 = time.time()
    state = fidelity_state_dict(hps)
    mel = jax_random.normal(jax_random.key(0), (batch, FRAMES, hps.data.n_mel_channels))
    mel = torch.from_numpy(mel * np.float32(2) - np.float32(4)).to(device)
    lens = torch.full((batch,), FRAMES, dtype=torch.int64, device=device)
    log(f"weights (fidelity recipe) and mel in {time.time() - t0:.1f} s; device {device}, "
        f"kernels={kernels}, wn_kernels={wn_kernels}, dtype={dtype}, hifi={hifi}")

    def vocoder(level: int) -> Vocoder:
        v = Vocoder(hps, state, dtype=dtype, use_kernels=kernels, use_wn_kernels=wn_kernels,
                    hifi=level, device=device)
        if kernels and (not v.use_kernels or v.dec_packed is None):
            raise RuntimeError("the kernel route was asked for and not taken "
                               f"(use_kernels={v.use_kernels})")
        if wn_kernels and not v.use_wn_kernels:
            raise RuntimeError("the WN kernel route was asked for and not taken")
        return v

    # the kernels a timed call must launch on the card: the tensor-core
    # bodies, or in f32 their FMA forms
    fma = "_fma" if f32 else ""
    routed = ([f"mrf_stage{fma}", f"up_mrf_stage{fma}"] if kernels else []) + (
        [f"wn_stack{fma}"] if wn_kernels else [])

    def leg(v: Vocoder, label: str) -> float:
        gen = torch.Generator(device=device).manual_seed(NOISE_SEED)
        t0 = time.time()
        v._infer(mel, lens, torch.randn((batch, FRAMES, hps.model.inter_channels),
                                        generator=gen, device=device), NOISE_SCALE)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        log(f"{label}: first call (with any kernel build) {time.time() - t0:.1f} s")
        dt, calls, launches, out = timed(v, mel, lens, iters, gen)
        out = out.float()
        if not torch.isfinite(out).all() or out.shape != (batch, FRAMES * hop, 1):
            raise RuntimeError(f"{label}: bad output {tuple(out.shape)}")
        if device.type == "cuda" and not all(launches.get(k) for k in routed):
            raise RuntimeError(f"{label}: launches a call {launches}, expected {routed}")
        log(f"{label}: {dt * 1e3:.2f} ms/step (mean of {iters}); per call median "
            f"{statistics.median(calls):.2f}, min {min(calls):.2f}, max {max(calls):.2f} ms; "
            f"launches a call {launches}; checksum {out.sum().item():.3f}")
        return dt

    serving = vocoder(hifi)
    dt = leg(serving, f"hifi {hifi}" if kernels else "module graph")
    audio_s = batch * FRAMES * hop / sr
    rtf = audio_s / dt
    log(f"{dt * 1e3:.2f} ms/step for {audio_s:.1f} s of audio ({batch} x {FRAMES} frames): "
        f"{rtf:.1f}x real time")

    rtf_fast = None
    if hifi:
        fast_vocoder = vocoder(0)
        rtf_fast = audio_s / leg(fast_vocoder, "hifi 0 (fast bf16)")
        del fast_vocoder

    mel_l1, mel_l1_serving = fidelity_vs_reference(hps, state, serving, fixture)
    tflops = synthesis_flops(hps, batch, FRAMES) / dt / 1e12
    log(f"model FLOPs {synthesis_flops(hps, batch, FRAMES) / 1e12:.2f} T a step -> "
        f"{tflops:.2f} TFLOP/s = {100 * tflops * 1e12 / H100_BF16_PEAK:.2f}% of the H100's "
        "bf16 peak")

    result = {"metric": "rtf_22k05_synthesis", "value": rtf, "unit": "x_realtime",
              "achieved_tflops_per_s": tflops, "mfu": tflops * 1e12 / H100_BF16_PEAK}
    if mel_l1 is not None:
        result["mel_l1_vs_reference"] = mel_l1
        result["fidelity_target"] = FIDELITY_TARGET
        mode = "hifi" if hifi else "f32" if f32 else "bf16"
        result[f"mel_l1_serving_{mode}"] = mel_l1_serving
    if rtf_fast is not None:
        result["rtf_fast_bf16"] = rtf_fast
    if train:
        result.update(train_metrics(config))
    else:
        log("train phase: skipped by flag")
    result.update(device=device_label(device), hifi=hifi,
                  cudnn_benchmark=bool(torch.backends.cudnn.benchmark))
    print(json.dumps(result), flush=True)
    return result


def _cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--no-kernels", action="store_true",
                    help="the module graph in bf16 (bench.py --no-pallas)")
    ap.add_argument("--wn-kernels", action="store_true",
                    help="the prior and flow on the WN kernel (bench.py --pallas-wn)")
    ap.add_argument("--f32", action="store_true", help="f32 serving")
    ap.add_argument("--fast", action="store_true", help="time hifi 0 as the headline")
    ap.add_argument("--no-train", action="store_true", help="leave out the train phase")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--config", default=CONFIG)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args()
    main(device=args.device, config=args.config, batch=args.batch, iters=args.iters,
         kernels=not args.no_kernels, wn_kernels=args.wn_kernels, f32=args.f32,
         fast=args.fast, train=not args.no_train)


if __name__ == "__main__":
    _cli()

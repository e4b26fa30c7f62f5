"""Live-serving operating points on the card: first-audio latency against
real-time factor, and the multi-stream sweep.

Counterpart of ``scripts/bench_streaming.py``. ``stream_mel_to_wav`` emits its
first audio once ``chunk - overlap`` frames are buffered; a smaller chunk cuts
that wait but decodes each frame ``chunk / step`` times and runs the card at
B = 1 on short windows. Per operating point (B = 1, iitp_base, bf16 at the
config's hifi level, weights from the seeded init):

  buffer_ms      = (chunk - overlap) * hop / sr * 1000  (frames to the first window)
  compute_ms     = host ms of one ``_synth_window`` (it ends in the copy of its
                   waveform to the host), median of interleaved rounds, (min-max)
  first_audio_ms = buffer_ms + compute_ms (mel arriving in real time)
  rtf_steady     = step * hop / sr / compute  (throughput while streaming)
  seam           = max |chunked - whole| / RMS(whole) on a 1536-frame decode
                   whose whole-utterance noise is ``positional_eps(seed, 0)``

Then the warm-up table: the first window at each chunk size in this process
(cold: the kernel library's load, cuDNN's plan choice, the allocator's growth)
against one after ``Vocoder.warmup``. Run it in a fresh process for a true cold
number.

Multi-stream sweep (``StreamServer``, one ``(N, chunk)`` program per N, every
stream fed ahead so that each step decodes N windows):

  window_ms     = host ms of one ``step()``, median of interleaved rounds
  stream_rtf    = step * hop / sr / window  (each stream's real-time margin)
  aggregate_rtf = N * stream_rtf
  max_diff      = max |batched - B = 1| of two streams co-batched on the
                  N-row server against each alone through ``stream_mel_to_wav``

Every table names the device: the card and its power limit as ``nvidia-smi``
reports them. ``main(device="cpu", hps=..., state=...)`` runs the same code
on the CPU at a small size; its times are the host's, not the card's.

Usage: python -m smart_vocoder_torch.tools.bench_streaming [--rounds R] [--iters I]
       [--points 1024:128,384:96,256:64] [--streams 1,8,32] [--stream-point 384:96]
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from smart_vocoder_torch.config import load_config
from smart_vocoder_torch.inference import Vocoder
from smart_vocoder_torch.models import build_synthesizer
from smart_vocoder_torch.ops import positional_eps
from smart_vocoder_torch.serving import StreamServer
from smart_vocoder_torch.utils.device import resolve_device
from smart_vocoder_torch.utils.init import init_synthesizer

POINTS = ((1024, 128), (384, 96), (256, 64))
STREAMS = (1, 8, 32)
STREAM_POINT = (384, 96)
SEAM_FRAMES = 1536
SEED = 1234
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_label(device: torch.device) -> str:
    """The card's name and power limit (``nvidia-smi``), or what the CPU run is."""
    if device.type != "cuda":
        return "cpu: host times, not a device measurement"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def interleaved_ms(legs: dict, iters: int, rounds: int) -> dict:
    """Host ms per call of each leg (each call ends in a copy to the host, so
    the device has finished): one warm-up call each, then ``rounds``
    interleaved rounds of ``iters`` calls, every other round in reverse
    order, as ``chip_smoke.py:time_legs``; ``{leg: (median, min, max)}``."""
    for fn in legs.values():
        fn()
    times = {name: [] for name in legs}
    order = list(legs.items())
    for r in range(rounds):
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times[name].append((time.perf_counter() - t0) / iters * 1e3)
    return {name: (statistics.median(v), min(v), max(v)) for name, v in times.items()}


def warmup_table(voc: Vocoder, chunks, label: str) -> list[dict]:
    """The first window at each chunk size, then one after ``warmup``."""
    n_mels = int(voc.hps.data.n_mel_channels)
    mel = np.full((max(chunks), n_mels), -4.0, np.float32)

    def window(c):
        t0 = time.perf_counter()
        voc._synth_window(mel[:c], 0, c, 0.667, None, SEED)
        return (time.perf_counter() - t0) * 1e3

    cold = {c: window(c) for c in chunks}
    voc.warmup(chunks)
    rows = [{"chunk": c, "cold_ms": cold[c], "warm_ms": window(c)} for c in chunks]
    print(f"first window, cold vs after warmup  [{label}]")
    print(f"{'chunk':>6} {'cold_ms':>10} {'warm_ms':>10}")
    for row in rows:
        print(f"{row['chunk']:>6} {row['cold_ms']:>10.2f} {row['warm_ms']:>10.2f}")
    return rows


def point_table(voc: Vocoder, points, iters: int, rounds: int, label: str,
                seam_frames: int = SEAM_FRAMES) -> list[dict]:
    """B = 1 operating points: window time, first-audio latency, seam."""
    hps = voc.hps
    sr, hop, n_mels = hps.data.sampling_rate, hps.data.hop_length, hps.data.n_mel_channels
    rng = np.random.default_rng(SEED)
    mel_long = rng.normal(-4, 2, (seam_frames, n_mels)).astype(np.float32)
    eps = positional_eps([SEED], [0], seam_frames, int(hps.model.inter_channels))
    whole = voc.mel_to_wav(mel_long[None], noise_scale=0.667, eps=eps.numpy())[0]
    rms = float(np.sqrt(np.mean(whole ** 2)))

    legs = {}
    for chunk, overlap in points:
        mel = rng.normal(-4, 2, (chunk, n_mels)).astype(np.float32)
        legs[(chunk, overlap)] = (lambda m=mel, c=chunk:
                                  voc._synth_window(m, 0, c, 0.667, None, SEED))
    times = interleaved_ms(legs, iters, rounds)
    print(f"B = 1 operating points, compute_ms median of {rounds} interleaved rounds of "
          f"{iters} (min-max)  [{label}]")
    print(f"{'chunk':>6} {'ovl':>4} {'step':>5} {'buffer_ms':>10} {'compute_ms':>26} "
          f"{'first_audio_ms':>15} {'rtf_steady':>11} {'seam':>9}")
    rows = []
    for (chunk, overlap), (ms, lo, hi) in times.items():
        step = chunk - 2 * overlap
        buffer_ms = (chunk - overlap) * hop / sr * 1e3
        chunked = voc.mel_to_wav_chunked(mel_long, chunk=chunk, overlap=overlap,
                                         noise_scale=0.667, seed=SEED)
        seam = float(np.max(np.abs(chunked - whole))) / rms
        row = {"chunk": chunk, "overlap": overlap, "buffer_ms": buffer_ms, "compute_ms": ms,
               "compute_ms_min": lo, "compute_ms_max": hi, "first_audio_ms": buffer_ms + ms,
               "rtf_steady": step * hop / sr / (ms / 1e3), "seam": seam}
        rows.append(row)
        print(f"{chunk:>6} {overlap:>4} {step:>5} {buffer_ms:>10.1f} "
              f"{f'{ms:.2f} ({lo:.2f}-{hi:.2f})':>26} {buffer_ms + ms:>15.1f} "
              f"{row['rtf_steady']:>11.1f} {seam:>9.2e}")
    return rows


def _fed_server(voc: Vocoder, n: int, chunk: int, overlap: int, steps: int, rng):
    """An n-row server with n streams each fed for ``steps`` full steps."""
    server = StreamServer(voc, max_streams=n, chunk=chunk, overlap=overlap)
    frames = (steps + 1) * (chunk - 2 * overlap) + chunk
    for i in range(n):
        h = server.open(seed=SEED + i)
        server.feed(h, rng.normal(-4, 2, (frames, voc.hps.data.n_mel_channels))
                    .astype(np.float32))
    return server


def stream_table(voc: Vocoder, point, ns, iters: int, rounds: int, label: str) -> list[dict]:
    """The multi-stream sweep at one (chunk, overlap)."""
    hps = voc.hps
    sr, hop, n_mels = hps.data.sampling_rate, hps.data.hop_length, hps.data.n_mel_channels
    chunk, overlap = point
    step = chunk - 2 * overlap
    rng = np.random.default_rng(SEED + 1)
    servers = {n: _fed_server(voc, n, chunk, overlap, 2 + rounds * iters, rng) for n in ns}

    def stepper(n):
        def fn():
            if len(servers[n].step()) != n:
                raise RuntimeError(f"a step of the {n}-stream server did not decode {n} windows")
        return fn

    times = interleaved_ms({n: stepper(n) for n in ns}, iters, rounds)
    rows = []
    for n in ns:
        # two streams co-batched on an n-row server against each alone at B = 1
        server = StreamServer(voc, max_streams=n, chunk=chunk, overlap=overlap)
        mels = [rng.normal(-4, 2, (3 * chunk, n_mels)).astype(np.float32) for _ in range(2)]
        handles = [server.open(seed=SEED + 11 + i) for i in range(min(n, 2))]
        got = {h: [] for h in handles}
        for h, wav in server.run({h: iter([m]) for h, m in zip(handles, mels)}):
            got[h].append(wav)
        worst = 0.0
        for i, h in enumerate(handles):
            want = np.concatenate(list(voc.stream_mel_to_wav(
                [mels[i]], chunk=chunk, overlap=overlap, seed=SEED + 11 + i)))
            have = np.concatenate(got[h])
            if have.shape != want.shape:
                raise RuntimeError(f"{n} streams: batched {have.shape} vs B = 1 {want.shape}")
            worst = max(worst, float(np.max(np.abs(have - want))))
        ms, lo, hi = times[n]
        stream_rtf = step * hop / sr / (ms / 1e3)
        rows.append({"streams": n, "chunk": chunk, "overlap": overlap, "window_ms": ms,
                     "window_ms_min": lo, "window_ms_max": hi, "stream_rtf": stream_rtf,
                     "aggregate_rtf": n * stream_rtf, "max_diff": worst})
    print(f"multi-stream sweep at {chunk}:{overlap}, window_ms median of {rounds} interleaved "
          f"rounds of {iters} steps (min-max)  [{label}]")
    print(f"{'streams':>7} {'window_ms':>26} {'stream_rtf':>11} {'aggregate_rtf':>14} "
          f"{'max_diff':>9}")
    for r in rows:
        span = f"{r['window_ms']:.2f} ({r['window_ms_min']:.2f}-{r['window_ms_max']:.2f})"
        print(f"{r['streams']:>7} {span:>26} {r['stream_rtf']:>11.1f} "
              f"{r['aggregate_rtf']:>14.1f} {r['max_diff']:>9.2e}")
    return rows


def main(argv=None, hps=None, state=None, device=None, seam_frames: int = SEAM_FRAMES) -> dict:
    """Warm-up table, operating points and stream sweep; returns their rows.
    ``hps`` and ``state`` default to iitp_base with the seeded init."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--points", default=",".join(f"{c}:{o}" for c, o in POINTS))
    ap.add_argument("--streams", default=",".join(map(str, STREAMS)))
    ap.add_argument("--stream-point", default="{}:{}".format(*STREAM_POINT))
    args = ap.parse_args(argv)
    points = [tuple(int(v) for v in p.split(":")) for p in args.points.split(",")]
    stream_point = tuple(int(v) for v in args.stream_point.split(":"))
    ns = [int(v) for v in args.streams.split(",")]

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
    if hps is None:
        hps = load_config(os.path.join(_ROOT, "configs", "iitp_base.json"))
    if state is None:
        state = init_synthesizer(build_synthesizer(hps), SEED).state_dict()
    voc = Vocoder(hps, state, dtype=torch.bfloat16, device=dev)
    label = f"{device_label(dev)}; {hps.model.inter_channels}-channel latent, hifi {voc.hifi}"
    chunks = sorted({c for c, _ in points} | {stream_point[0]}, reverse=True)
    return {"device": label,
            "warmup": warmup_table(voc, chunks, label),
            "points": point_table(voc, points, args.iters, args.rounds, label, seam_frames),
            "streams": stream_table(voc, stream_point, ns, args.iters, args.rounds, label)}


if __name__ == "__main__":
    import json

    print(json.dumps(main()))

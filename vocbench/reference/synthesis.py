"""The reference's answers for the synthesis cells: what ``Vocoder.mel_to_wav``
returns for a batch call, and what a live stream's pieces join to.

Both follow the program's published contracts, worked out here again from the
inputs the benchmark made:

- a batch call pads every row to the next bucket (the program's default
  buckets), draws the noise by ``noise.batch_eps`` at that length, decodes,
  and cuts each row to its true length;
- a stream is decoded in windows of ``chunk`` frames that overlap by
  ``overlap`` on each side, each keeping its middle ``chunk - 2 * overlap``
  frames; a window is padded to ``chunk`` frames, its length is its true
  frames, and its noise is ``noise.positional_eps`` from its first frame.

The reference runs in blocks of rows, so that a full cell fits beside what is
left of the program's memory.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from vocbench.reference import graph, noise

BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)  # Vocoder's default buckets


def bucket(t: int) -> int:
    i = bisect.bisect_left(BUCKETS, t)
    return BUCKETS[i] if i < len(BUCKETS) else t


@torch.no_grad()
def batch_call(p, s: graph.Sizes, mel: np.ndarray, lengths: np.ndarray, noise_scale: float,
               seed: int, device, nx: graph.Numerics = graph.F32, block: int = 8,
               sid: np.ndarray | None = None) -> list[np.ndarray]:
    """One ``mel_to_wav`` call: mel (B, T, n_mels) -> B waveforms of
    ``lengths[i] * hop`` samples."""
    b, t, _ = mel.shape
    padded = bucket(t)
    mel = np.pad(np.asarray(mel, np.float32), ((0, 0), (0, padded - t), (0, 0)))
    eps = noise.batch_eps(seed, b, padded, s.inter)
    out = []
    for r0 in range(0, b, block):
        rows = slice(r0, min(b, r0 + block))
        wav = graph.infer(p, s, torch.from_numpy(mel[rows]).to(device),
                          torch.as_tensor(lengths[rows], dtype=torch.int64, device=device),
                          eps[rows].to(device), noise_scale,
                          None if sid is None else torch.as_tensor(sid[rows], device=device),
                          nx=nx)
        out.extend(wav.cpu().numpy())
    return [w[: int(n) * s.hop] for w, n in zip(out, lengths)]


def windows(t: int, chunk: int, overlap: int) -> list[tuple[int, int, int, int]]:
    """The windows of a ``t``-frame stream: ``(lo, hi, keep_lo, keep_hi)``
    absolute frames, decoded ``[lo, hi)``, kept ``[keep_lo, keep_hi)``."""
    step = chunk - 2 * overlap
    if not 0 <= overlap < chunk // 2:
        raise ValueError(f"overlap {overlap} must lie in [0, chunk // 2) for chunk {chunk}")
    out = []
    for start in range(0, t, step):
        lo, hi = max(0, start - overlap), min(t, start + step + overlap)
        out.append((lo, hi, start, min(hi, start + step)))
    return out


@torch.no_grad()
def streams(p, s: graph.Sizes, mels: list[np.ndarray], seeds: list[int], sids: list,
            noise_scales: list[float], chunk: int, overlap: int, device,
            nx: graph.Numerics = graph.F32, block: int = 32) -> list[np.ndarray]:
    """Each stream's whole waveform: mel (T_i, n_mels) a stream, its seed,
    speaker (or None) and noise scale."""
    jobs = []  # (stream, window) for every window of every stream
    for k, mel in enumerate(mels):
        for w in windows(mel.shape[0], chunk, overlap):
            jobs.append((k, w))
    pieces: dict[tuple, np.ndarray] = {}
    hop = s.hop
    for j0 in range(0, len(jobs), block):
        part = jobs[j0: j0 + block]
        n = len(part)
        mel_b = np.zeros((n, chunk, s.n_mels), np.float32)
        lens = np.zeros((n,), np.int64)
        for r, (k, (lo, hi, _, _)) in enumerate(part):
            mel_b[r, : hi - lo] = mels[k][lo:hi]
            lens[r] = hi - lo
        eps = noise.positional_eps([seeds[k] for k, _ in part], [w[0] for _, w in part],
                                   chunk, s.inter, device=device)
        sid = None
        if s.conditioned:
            sid = torch.as_tensor([int(sids[k]) for k, _ in part], device=device)
        scale = torch.as_tensor([noise_scales[k] for k, _ in part], dtype=torch.float32)
        wav = graph.infer(p, s, torch.from_numpy(mel_b).to(device),
                          torch.from_numpy(lens).to(device), eps, scale.to(device), sid,
                          nx=nx).cpu().numpy()
        for r, (k, (lo, hi, keep_lo, keep_hi)) in enumerate(part):
            pieces[(k, keep_lo)] = wav[r, (keep_lo - lo) * hop: (keep_hi - lo) * hop]
    out = []
    for k, mel in enumerate(mels):
        out.append(np.concatenate([pieces[(k, w[2])]
                                   for w in windows(mel.shape[0], chunk, overlap)]))
    return out

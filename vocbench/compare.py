"""The comparison that decides ``correct``: the program's answers against the
plain reference's, each number beside its limit.

Synthesis (the batch and live cells) compares waveforms one by one:

- ``wav_rel_l2``: the worst answer's ``||got - want|| / ||want||``;
- ``mel_l1``: the worst answer's mean absolute gap of log-mel spectrograms
  (the repository's fidelity measure), over its whole length.

An answer of another length than the reference's, or one that holds a
non-finite sample, reads infinite. Which of these numbers a cell holds to a
limit is its traffic file's ``limits``; every number is printed. The
synthesis cells hold ``mel_l1`` only: ``wav_rel_l2`` swings from seed to seed
by its nature (the output's tanh saturates; one row's phase near a zero
crossing decides it), and the float8 control reads below the program on some
seeds, so no limit could separate the two.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from vocbench.harness import Check
from vocbench.reference import audio


@contextlib.contextmanager
def reference_precision():
    """Float32 products in float32: TF32 off for matmuls and cuDNN's
    convolutions while the reference runs, as they were."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def waveform_gaps(got: list[np.ndarray], want: list[np.ndarray], data: dict) -> dict:
    """The worst answer's gap by each measure, and how many answers there were."""
    rel, mel = [], []
    for g, w in zip(got, want, strict=True):
        g = np.asarray(g, np.float32).reshape(-1)
        w = np.asarray(w, np.float32).reshape(-1)
        if g.shape != w.shape or not np.isfinite(g).all():
            rel.append(np.inf)
            mel.append(np.inf)
            continue
        rel.append(float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)))
        both = torch.from_numpy(np.stack([g, w]))
        m = audio.mel_spectrogram(both, data)
        mel.append(float((m[0] - m[1]).abs().mean()))
    return {"wav_rel_l2": max(rel), "mel_l1": max(mel), "answers": len(rel)}


def waveform_checks(got, want, limits: dict, data: dict) -> list[Check]:
    gaps = waveform_gaps(got, want, data)
    print(f"compared {gaps['answers']} answers: wav_rel_l2 {gaps['wav_rel_l2']!r}, "
          f"mel_l1 {gaps['mel_l1']!r}", file=sys.stderr)
    return [Check(name, float(gaps[name]), float(limit)) for name, limit in limits.items()]

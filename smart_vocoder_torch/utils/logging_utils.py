"""Run logging: the ``train.log`` logger, the summary writer, spectrogram
images and git-hash provenance (reference utils.py:59-131, :194-226);
counterpart of ``smart_vocoder_tpu/utils/logging_utils.py``, with the
reference's scalar names (``loss/g/total``, ...; train.py:224-229).

Where ``tensorboardX`` does not import, ``make_writer`` returns a
``PlainWriter``: scalars as ``{"step", "tag", "value"}`` lines in
``<dir>/scalars.jsonl``, images as ``.npy`` and audio as ``.wav`` under
``<dir>/images`` and ``<dir>/audio``. Without matplotlib a spectrogram
"image" is the raw ``(n_mels, frames)`` array.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
from typing import Dict, Optional

import numpy as np


def get_logger(model_dir: str, filename: str = "train.log") -> logging.Logger:
    """File logger at ``<model_dir>/train.log`` and stdout (ref:
    utils.py:214-226), named after the directory. A file handler left by an
    earlier run of another directory of the same name is replaced."""
    logger = logging.getLogger(os.path.basename(os.path.normpath(model_dir)))
    logger.setLevel(logging.DEBUG)
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(model_dir, filename))
    for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
        if h.baseFilename != path:
            logger.removeHandler(h)
            h.close()
    if not any(isinstance(h, logging.FileHandler) for h in logger.handlers):
        h = logging.FileHandler(path)
        h.setLevel(logging.DEBUG)
        h.setFormatter(logging.Formatter("%(asctime)s\t%(name)s\t%(levelname)s\t%(message)s"))
        logger.addHandler(h)
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        logger.addHandler(logging.StreamHandler(sys.stdout))
    return logger


def _write_wav(log_dir: str, tag: str, step: int, wav: np.ndarray, sampling_rate: int) -> None:
    from scipy.io import wavfile

    out_dir = os.path.join(log_dir, "audio")
    os.makedirs(out_dir, exist_ok=True)
    wavfile.write(os.path.join(out_dir, f"{tag.replace('/', '_')}_{step}.wav"), sampling_rate,
                  (np.clip(wav, -1, 1) * 32767).astype(np.int16))


class PlainWriter:
    """The summary writer where tensorboardX is missing, under the same tags."""

    def __init__(self, log_dir: str):
        self.logdir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._scalars = open(os.path.join(log_dir, "scalars.jsonl"), "a", encoding="utf-8")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._scalars.write(json.dumps({"step": int(step), "tag": tag, "value": float(value)})
                            + "\n")
        self._scalars.flush()

    def add_image(self, tag: str, img, step: int, dataformats: str = "HWC") -> None:
        out_dir = os.path.join(self.logdir, "images")
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, f"{tag.replace('/', '_')}_{step}.npy"), np.asarray(img))

    def add_audio(self, tag: str, wav, step: int, sample_rate: int) -> None:
        _write_wav(self.logdir, tag, step, np.asarray(wav, np.float32).reshape(-1), sample_rate)

    def close(self) -> None:
        self._scalars.close()


def make_writer(log_dir: str):
    """tensorboardX's ``SummaryWriter`` where it imports, else a ``PlainWriter``."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return PlainWriter(log_dir)
    return SummaryWriter(log_dir=log_dir)


def summarize(writer, global_step: int, scalars: Optional[Dict] = None,
              images: Optional[Dict] = None, audios: Optional[Dict] = None,
              audio_sampling_rate: int = 22050) -> None:
    """The reference's summarize (utils.py:59-67). An image is HWC (a
    rendered plot) or HW (a raw spectrogram where matplotlib is missing)."""
    for k, v in (scalars or {}).items():
        writer.add_scalar(k, float(v), global_step)
    for k, v in (images or {}).items():
        v = np.asarray(v)
        writer.add_image(k, v, global_step, dataformats="HWC" if v.ndim == 3 else "HW")
    for k, v in (audios or {}).items():
        wav = np.asarray(v, dtype=np.float32).reshape(-1, 1)
        try:
            writer.add_audio(k, wav, global_step, audio_sampling_rate)
        except ModuleNotFoundError:  # tensorboardX's encoder needs soundfile
            _write_wav(getattr(writer, "logdir", "."), k, global_step, wav[:, 0],
                       audio_sampling_rate)


def plot_spectrogram_to_numpy(spectrogram: np.ndarray) -> np.ndarray:
    """An (n_mels, frames) array rendered as an RGB image (ref:
    utils.py:78-101); the array itself where matplotlib is missing."""
    try:
        import matplotlib
    except ImportError:
        return np.asarray(spectrogram, np.float32)
    matplotlib.use("Agg")
    logging.getLogger("matplotlib").setLevel(logging.WARNING)
    import matplotlib.pylab as plt

    fig, ax = plt.subplots(figsize=(10, 2))
    im = ax.imshow(np.asarray(spectrogram), aspect="auto", origin="lower",
                   interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.xlabel("Frames")
    plt.ylabel("Channels")
    plt.tight_layout()
    fig.canvas.draw()
    data = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    data = data.reshape(fig.canvas.get_width_height()[::-1] + (4,))[..., :3]
    plt.close(fig)
    return data.copy()


def check_git_hash(model_dir: str, logger: Optional[logging.Logger] = None) -> None:
    """Warn when a run directory was started at another git HEAD (ref:
    utils.py:194-211)."""
    log = logger or logging.getLogger(__name__)
    source_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.realpath(__file__))))
    if not os.path.exists(os.path.join(source_dir, ".git")):
        log.warning("%s is not a git repository; hash comparison skipped", source_dir)
        return
    cur_hash = subprocess.getoutput(f"git -C {source_dir} rev-parse HEAD")
    path = os.path.join(model_dir, "githash")
    if os.path.exists(path):
        with open(path) as f:
            saved_hash = f.read()
        if saved_hash != cur_hash:
            log.warning("git hash values are different. %s(saved) != %s(current)",
                        saved_hash[:8], cur_hash[:8])
    else:
        os.makedirs(model_dir, exist_ok=True)
        with open(path, "w") as f:
            f.write(cur_hash)

"""Hyper-parameter / config system: the JSON schema of ``configs/*.json``.

Counterpart of ``smart_vocoder_tpu/config.py`` (JAX-free there too, copied so
this package never imports the JAX one). A config has three blocks --
``train``, ``data``, ``model`` -- plus optional runtime extras under ``tpu``
that all have defaults. ``model.kind`` names the model (:data:`MODEL_KINDS`);
the port reads ``tpu.use_pallas`` (route the decoder's
last two stages to the hand-written kernels), ``tpu.hifi_tail`` and the
training loop's extras (buckets, checkpoints kept, eval samples, profiling,
the spectrogram cache, ``debug_nans``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Iterator


class HParams:
    """Recursive dict -> attribute config object (reference: utils.py:229-258)."""

    def __init__(self, **kwargs: Any) -> None:
        for k, v in kwargs.items():
            if isinstance(v, dict):
                v = HParams(**v)
            self[k] = v

    def keys(self):
        return self.__dict__.keys()

    def items(self):
        return self.__dict__.items()

    def values(self):
        return self.__dict__.values()

    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, HParams) else v
                for k, v in self.__dict__.items()}

    def __len__(self) -> int:
        return len(self.__dict__)

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def __setitem__(self, key: str, value: Any) -> None:
        setattr(self, key, value)

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def __iter__(self) -> Iterator[str]:
        return iter(self.__dict__)

    def __repr__(self) -> str:
        return repr(self.__dict__)


# Runtime extras, overridable by a "tpu" block in the JSON config (the block
# keeps its name so both packages read the same files).
_TPU_DEFAULTS: Dict[str, Any] = {
    "bf16_run": None,  # None -> inherit train.fp16_run
    "bucket_boundaries": [32, 300, 400, 500, 600, 700, 800, 900, 1000],
    "data_parallel": -1,
    "model_parallel": 1,
    "use_pallas": False,
    "use_pallas_wn": False,
    "keep_ckpts": 5,
    "profile_steps": 0,
    "profile_start_step": 10,
    "debug_nans": False,
    "compilation_cache": True,
    "cache_specs": False,
    "eval_samples": 8,  # validation utterances scored by eval/mel_l1
}

_REQUIRED_TRAIN = ["learning_rate", "betas", "eps", "batch_size", "segment_size",
                   "c_mel", "c_kl", "lr_decay", "seed"]
# ``model.kind``: "smart" (the default: SMART-Vocoder's VAE, prior -> flow ->
# HiFi-GAN decoder) or "bigvgan" (a generator alone, ``models/bigvgan.py``,
# which no path trains, so its config needs no ``train`` block)
MODEL_KINDS = ("smart", "bigvgan")
_REQUIRED_DATA = ["sampling_rate", "filter_length", "hop_length", "win_length",
                  "n_mel_channels", "mel_fmin", "max_wav_value"]


def _fill_defaults(hps: HParams) -> HParams:
    tpu = hps.get("tpu")
    if tpu is None:
        tpu = HParams()
        hps["tpu"] = tpu
    for k, v in _TPU_DEFAULTS.items():
        if k not in tpu:
            tpu[k] = v
    if tpu.bf16_run is None:
        tpu.bf16_run = bool(hps.get("train", HParams()).get("fp16_run", False))
    if "mel_fmax" not in hps.data:
        hps.data["mel_fmax"] = None
    if "n_speakers" not in hps.data:
        hps.data["n_speakers"] = 0
    return hps


def model_kind(hps: HParams) -> str:
    """The config's ``model.kind``, "smart" where it names none."""
    kind = hps.model.get("kind", "smart")
    if kind not in MODEL_KINDS:
        raise ValueError(f"config.model.kind {kind!r}: one of {MODEL_KINDS}")
    return kind


def validate(hps: HParams) -> HParams:
    trains = model_kind(hps) == "smart"
    for key in _REQUIRED_TRAIN if trains else ():
        if key not in hps.train:
            raise ValueError(f"config.train missing required key: {key}")
    for key in _REQUIRED_DATA:
        if key not in hps.data:
            raise ValueError(f"config.data missing required key: {key}")
    if trains and hps.train.segment_size % hps.data.hop_length != 0:
        raise ValueError("train.segment_size must be a multiple of data.hop_length")
    return _fill_defaults(hps)


def load_config(config_path: str) -> HParams:
    """Load + validate a JSON config file (reference: utils.py:185-191)."""
    with open(config_path, "r", encoding="utf-8") as f:
        config = json.load(f)
    return validate(HParams(**config))


def get_hparams_from_dir(model_dir: str) -> HParams:
    """The config snapshot of a run directory (reference: utils.py:174-182)."""
    hps = load_config(os.path.join(model_dir, "config.json"))
    hps.model_dir = model_dir
    return hps


def get_hparams(args=None, init: bool = True) -> HParams:
    """CLI entry: ``-c/--config`` and ``-m/--model`` -> HParams with
    ``.model_dir`` = ``./logs/<model>``. ``init`` copies the config there as
    ``config.json``; ``init=False`` reads that snapshot instead (reference:
    utils.py:144-171). Unknown arguments are left to the caller."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, default="./configs/iitp_base.json",
                        help="JSON file for configuration")
    parser.add_argument("-m", "--model", type=str, required=True, help="Model name")
    ns, _ = parser.parse_known_args(args)

    model_dir = os.path.join("./logs", ns.model)
    os.makedirs(model_dir, exist_ok=True)
    config_save_path = os.path.join(model_dir, "config.json")
    if init:
        with open(ns.config, "r", encoding="utf-8") as f:
            data = f.read()
        with open(config_save_path, "w", encoding="utf-8") as f:
            f.write(data)
    else:
        with open(config_save_path, "r", encoding="utf-8") as f:
            data = f.read()
    hps = validate(HParams(**json.loads(data)))
    hps.model_dir = model_dir
    return hps

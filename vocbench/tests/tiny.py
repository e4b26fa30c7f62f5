"""A tiny configuration and traffic for the CPU tests: every cell's driver,
the reference and the comparison at sizes the CPU runs in seconds."""

from __future__ import annotations

import copy
import torch

from vocbench import run


CONFIG = {
    "train": {"log_interval": 200, "eval_interval": 1000, "seed": 0, "epochs": 100,
              "learning_rate": 2e-4, "betas": [0.8, 0.99], "eps": 1e-9, "batch_size": 2,
              "fp16_run": True, "lr_decay": 0.999875, "segment_size": 256, "c_mel": 45,
              "c_kl": 1.0},
    "data": {"training_files": "", "validation_files": "", "max_wav_value": 32768.0,
             "sampling_rate": 22050, "filter_length": 256, "hop_length": 16,
             "win_length": 256, "n_mel_channels": 80, "mel_fmin": 0.0, "mel_fmax": None,
             "n_speakers": 5},
    "model": {"inter_channels": 16, "hidden_channels": 16, "resblock": "1",
              "resblock_kernel_sizes": [3, 7, 11],
              "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
              "upsample_rates": [4, 2, 2], "upsample_initial_channel": 256,
              "upsample_kernel_sizes": [8, 4, 4], "gin_channels": 8, "enc_layers": 2,
              "flow_wn_layers": 2},
    "tpu": {"use_pallas": True, "bf16_run": True, "bucket_boundaries": [32, 40, 48, 56]},
}

# The tiny model's limits: its bf16 gaps to the float32 reference are wider
# than the full-size model's (16 channels), so the cells' limits do not fit
# it. Each is about twice the sound run's reading at these sizes and seeds,
# and below what the float8 control reads (the tests hold both).
TRAFFIC = {
    "batch": {"batch": 4, "frames": [64, 120], "pool_calls": 2,
              "limits": {"mel_l1": 0.03}},
    "live": {"rate_per_s": 4.0, "frames": [64, 120], "max_streams": 4, "chunk": 64,
             "overlap": 16, "check_streams": 5, "limits": {"mel_l1": 0.03}},
    "train": {"frames": [33, 56], "clips_per_bucket": 2,
              "limits": {"change_g": 0.5, "change_d": 0.1, "change_d_med": 0.0008}},
}


# Cells whose driver, traffic, readers and reference stay, though
# ``BENCHMARK.json`` runs them no more (PERF.md §7): the tests still drive them.
PARKED = {"iitp_base.train": {"name": "iitp_base.train", "config": "iitp_base",
                              "traffic": "train", "chips": 1}}


def bench() -> dict:
    return run.load_json("BENCHMARK.json")


def context(cell_name: str, seed: int = 2 ** 33 + 5, seconds: float = 2.0,
            conditioned: bool | None = None, f32: bool = False):
    """The cell's driver context on the CPU at the tiny sizes."""
    b = bench()
    cell = PARKED.get(cell_name) or run.find(b["workloads"], cell_name, "workload")
    cfg = copy.deepcopy(CONFIG)
    if conditioned is None:
        conditioned = cell["config"].endswith("_ms")
    cfg["model"]["use_spk_embed"] = conditioned
    if f32:
        cfg["train"]["fp16_run"] = False
        cfg["tpu"]["bf16_run"] = False
    ctx = run.make_context(cell, b, seed, seconds, False, torch.device("cpu"), cfg)
    ctx.traffic.update(copy.deepcopy(TRAFFIC[ctx.traffic["driver"]]))
    ctx.log = lambda *a: None
    return ctx, b

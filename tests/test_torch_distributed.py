"""Data parallelism of the port's train step over ``torch.distributed`` on
the CPU: two gloo processes of B = 2 rows each against one process of the
same B = 4 rows, from the same seeded weights, with the posterior noise, the
slice starts and the jigsaw permutation passed in, and unequal lengths on
the two ranks (32 + 29 frames against 21 + 17).

- Step 1's G and D gradients, averaged over the ranks, equal the single
  process's within 1e-5 of their global norm; the metrics of steps 1-2,
  averaged over the ranks, within rel 1e-4. The tolerance is on gradients,
  not parameters: AdamW at eps 1e-9 turns a noise-level difference in a
  near-zero gradient into an lr-sized step.
- Dividing each rank's KL by its own mask sum (the global sum is 102 frames,
  rank 0 holds 61 and rank 1 holds 41) misses that tolerance: over G's whole
  gradient by more than 10x, and by more than 100x over the prior encoder
  ``enc_p``, whose only gradient is the KL's (the right denominator holds
  ``enc_p`` within the tolerance of its own norm too). The denominator must
  be the global one.

The workers import no JAX (``spawn`` re-imports this module). Two ranks
whose model directories differ (only the chief's holds a pair: it resumes,
the other starts fresh) both stop before a step, naming the disagreement;
on one shared directory both resume the pair and train on. Last, the
``train`` CLI under ``torchrun`` with two gloo ranks: both join the group
from torchrun's environment, the chief alone writes the log and the pairs,
and both leave the group at the end. Without torchrun the CLI starts
``tpu.data_parallel`` ranks itself (the rule: ``ranks_to_start``): two gloo
ranks train as under torchrun, and a rank that fails fails the command.
"""

import copy
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from smart_vocoder_torch import losses as losses_lib
from smart_vocoder_torch.config import HParams, validate
from smart_vocoder_torch.ops import stft_magnitude
from smart_vocoder_torch.parallel import dist as dist_lib
from smart_vocoder_torch.training import Batch, init_train_state, make_train_step
from smart_vocoder_torch.utils.checkpoint import CheckpointManager

CFG = {  # tests/test_train_step.py's tiny model, speaker-conditioned
    "train": dict(log_interval=1, eval_interval=100, seed=1234, epochs=1, learning_rate=2e-4,
                  betas=[0.8, 0.99], eps=1e-9, batch_size=2, fp16_run=False, lr_decay=0.999875,
                  segment_size=2048, c_mel=45, c_kl=1.0),
    "data": dict(training_files="", validation_files="", max_wav_value=32768.0,
                 sampling_rate=22050, filter_length=1024, hop_length=256, win_length=1024,
                 n_mel_channels=80, mel_fmin=0.0, mel_fmax=None, n_speakers=4),
    "model": dict(inter_channels=32, hidden_channels=32, resblock="1",
                  resblock_kernel_sizes=[3, 7], resblock_dilation_sizes=[[1, 3], [1, 3]],
                  upsample_rates=[8, 8, 2, 2], upsample_initial_channel=64,
                  upsample_kernel_sizes=[16, 16, 4, 4], gin_channels=16,
                  use_spectral_norm=False, use_spk_embed=True, enc_layers=2,
                  flow_wn_layers=2, disc_width_mult=0.125),
}
FRAMES = 32
LENGTHS = [32, 29, 21, 17]  # rank 0: rows 0-1, rank 1: rows 2-3
GRAD_TOL = 1e-5  # of the gradient's global norm
METRIC_REL = 1e-4


def global_batch():
    """The four rows (zero past each length) and the draws for them."""
    hps = validate(HParams(**copy.deepcopy(CFG)))
    hop = hps.data.hop_length
    rng = np.random.default_rng(0)
    lengths = np.asarray(LENGTHS, np.int32)
    wav = rng.uniform(-0.5, 0.5, (4, FRAMES * hop, 1)).astype(np.float32)
    for i, n in enumerate(lengths):
        wav[i, n * hop:] = 0
    wav_t = torch.from_numpy(wav)
    spec = stft_magnitude(wav_t[..., 0], hps.data.filter_length, hop, hps.data.win_length)
    for i, n in enumerate(lengths):
        spec[i, n:] = 0
    seg = hps.train.segment_size // hop
    draws = {"eps_q": torch.from_numpy(rng.standard_normal(
                 (4, FRAMES, hps.model.inter_channels)).astype(np.float32)),
             "ids_slice": torch.tensor([int(rng.integers(0, n - seg + 1)) for n in lengths],
                                       dtype=torch.int32),
             "perm": torch.tensor([2, 0, 3, 1])}
    batch = Batch(spec, torch.from_numpy(lengths), wav_t, torch.from_numpy(lengths * hop),
                  torch.arange(4) % hps.data.n_speakers)
    return hps, batch, draws


def rows(batch, draws, sel):
    part = Batch(*(v[sel] for v in (batch.spec, batch.spec_lengths, batch.wav,
                                    batch.wav_lengths, batch.sid)))
    return part, {"eps_q": draws["eps_q"][sel], "ids_slice": draws["ids_slice"][sel],
                  "perm": draws["perm"]}


def two_steps(sel, per_rank_kl=False):
    """Two steps on rows ``sel`` from the seeded weights: step 1's gradients
    as the optimizers see them, and each step's metrics averaged over the
    ranks (this process's own where there is no group)."""
    hps, batch, draws = global_batch()
    batch, draws = rows(batch, draws, sel)
    state = init_train_state(hps, seed=3, device="cpu")
    step = make_train_step(hps, device="cpu")
    grads = {"g_names": [n for n, _ in state.net_g.named_parameters()]}
    for tag, opt in (("g", state.opt_g), ("d", state.opt_d)):
        original = opt.step

        def capture(*a, tag=tag, opt=opt, original=original, **k):
            grads.setdefault(tag, [p.grad.clone() for grp in opt.param_groups
                                   for p in grp["params"]])
            return original(*a, **k)
        opt.step = capture
    kl = losses_lib.kl_loss
    per_rank = mock.patch.object(losses_lib, "kl_loss", lambda *a: kl(*a[:5]))
    metrics = []
    with per_rank if per_rank_kl else mock.patch.object(losses_lib, "kl_loss", kl):
        for _ in range(2):
            state, m = step(state, batch, **draws)
            metrics.append(dist_lib.mean_scalars(m))
    return {"grads": grads, "metrics": metrics}


def _worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        sel = slice(2 * rank, 2 * rank + 2)
        out = {"global": two_steps(sel), "per_rank": two_steps(sel, per_rank_kl=True)}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


free_port = dist_lib.free_port


def grad_error(got, want):
    """max |got - want| over a net's gradients, over their global norm."""
    norm = torch.linalg.vector_norm(torch.cat([w.reshape(-1) for w in want]))
    return max((g - w).abs().max().item() for g, w in zip(got, want)) / norm.item()


def test_two_gloo_ranks_match_one_process(tmp_path):
    mp.get_context("spawn")
    mp.start_processes(_worker, args=(2, free_port(), str(tmp_path)), nprocs=2, join=True,
                       start_method="spawn")
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = two_steps(slice(0, 4))
    finally:
        torch.set_num_threads(n)

    # every rank applied the same averaged gradients and logged the same means
    for tag in ("g", "d"):
        for a, b in zip(ranks[0]["global"]["grads"][tag], ranks[1]["global"]["grads"][tag]):
            assert torch.equal(a, b)
    errors = {tag: grad_error(ranks[0]["global"]["grads"][tag], single["grads"][tag])
              for tag in ("g", "d")}
    assert all(e <= GRAD_TOL for e in errors.values()), errors
    for s, (got, want) in enumerate(zip(ranks[0]["global"]["metrics"], single["metrics"])):
        assert set(got) == set(want)
        for k, w in want.items():
            assert abs(got[k] - w) <= METRIC_REL * abs(w), (s + 1, k, got[k], w)

    # each rank dividing its KL by its own mask sum is another function
    def enc_p(grads):
        return [g for n, g in zip(grads["g_names"], grads["g"]) if n.startswith("enc_p.")]

    right = grad_error(enc_p(ranks[0]["global"]["grads"]), enc_p(single["grads"]))
    wrong_g = grad_error(ranks[0]["per_rank"]["grads"]["g"], single["grads"]["g"])
    wrong = grad_error(enc_p(ranks[0]["per_rank"]["grads"]), enc_p(single["grads"]))
    assert right <= GRAD_TOL, right
    assert wrong_g > 10 * GRAD_TOL and wrong > 100 * GRAD_TOL, (wrong_g, wrong, errors)


def write_run_config(root):
    """Eight tones of 40-61 frames, a ``path|sid`` list and ``cfg.json`` for
    the loop: 2 batches a rank an epoch at 2 ranks."""
    from scipy.io import wavfile

    wav_dir = root / "wavs"
    wav_dir.mkdir()
    lines = []
    for i in range(8):
        t = np.arange((40 + 3 * i) * 256) / 22050
        path = wav_dir / f"u{i}.wav"
        wavfile.write(str(path), 22050, (np.sin(2 * np.pi * (120 + 15 * i) * t) * 8000)
                      .astype(np.int16))
        lines.append(f"{path}|{i % 4}")
    files = root / "files.txt"
    files.write_text("\n".join(lines) + "\n")
    cfg = copy.deepcopy(CFG)
    cfg["train"].update(eval_interval=2, epochs=3)
    cfg["data"].update(training_files=str(files), validation_files=str(files))
    cfg["tpu"] = {"bucket_boundaries": [32, 50, 70], "eval_samples": 2, "keep_ckpts": 2}
    (root / "cfg.json").write_text(json.dumps(cfg))


def _resume_worker(rank, world, port, root):
    from smart_vocoder_torch.training import loop as loop_lib
    from smart_vocoder_torch.utils.checkpoint import CheckpointManager

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        with open(os.path.join(root, "cfg.json")) as f:
            cfg = json.load(f)
        outcome = []
        # each rank on its own disk: only the chief's holds the pair; then one shared directory
        for model_dir in (f"node{rank}", "node0"):
            hps = validate(HParams(**copy.deepcopy(cfg)))
            hps.model_dir = os.path.join(root, model_dir)
            try:
                loop_lib.run(hps, max_steps=8, device="cpu")
                outcome.append("ran")
            except RuntimeError as e:
                outcome.append(str(e))
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(outcome, f)
    finally:
        dist.destroy_process_group()


def test_ranks_that_resume_different_states_stop(tmp_path):
    write_run_config(tmp_path)
    hps = validate(HParams(**json.loads((tmp_path / "cfg.json").read_text())))
    state = init_train_state(hps, seed=3, device="cpu")
    state.step = 6  # the pair a save at step 5 writes
    CheckpointManager(str(tmp_path / "node0")).save(5, state, 1, 2e-4)
    mp.start_processes(_resume_worker, args=(2, free_port(), str(tmp_path)), nprocs=2,
                       join=True, start_method="spawn")
    outcomes = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    for r, (apart, shared) in enumerate(outcomes):
        # rank 0 resumed (6, 1, 1), rank 1 started fresh (0, 1, 0): both stop before a step
        assert "the ranks disagree on the resumed (step, epoch, resumed): " \
            "from [0, 1, 0] to [6, 1, 1]" in apart, (r, apart)
        assert shared == "ran", (r, shared)
    log = (tmp_path / "node0" / "train.log").read_text()
    assert "resumed from step 6" in log
    assert [json.loads(ln.split("\t")[-1])[5] for ln in log.splitlines()
            if ln.split("\t")[-1].startswith("[")] == [6, 7]
    assert CheckpointManager(str(tmp_path / "node0")).steps() == [5, 8]
    assert not (tmp_path / "node1").exists() or not any((tmp_path / "node1").glob("*.pth"))


def test_train_cli_under_torchrun(tmp_path):
    write_run_config(tmp_path)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
         "-m", "smart_vocoder_torch.train", "-c", "cfg.json", "-m", "ddp", "--max-steps", "3",
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    model_dir = tmp_path / "logs" / "ddp"
    log = (model_dir / "train.log").read_text()
    assert "torch.distributed gloo: rank 0 of 2 on cpu" in log
    steps = [json.loads(ln.split("\t")[-1])[5] for ln in log.splitlines()
             if ln.split("\t")[-1].startswith("[")]
    assert steps == [0, 1, 2]
    assert "eval step 0" in log and "eval step 2" in log
    assert sorted(p.name for p in model_dir.glob("*.pth")) == ["D_2.pth", "D_3.pth",
                                                                  "G_2.pth", "G_3.pth"]


@pytest.mark.parametrize("data_parallel, cards, world, cpu, want", [
    (-1, 4, None, False, 4),     # every visible card
    (-1, 0, None, False, 1),     # no card: one process, and the device rule raises
    (-1, 4, None, True, 1),      # --device cpu: one process
    (2, 4, None, False, 2),
    (1, 4, None, False, 1),
    (3, 0, None, True, 3),       # gloo ranks on the CPU
    (5, 4, None, False, "5, and 4 CUDA cards"),
    (0, 4, None, False, "-1 .every card. or N"),
    (-1, 4, 4, False, 1),        # under torchrun: its ranks, each trains in-process
    (4, 4, 4, False, 1),
    (2, 4, 4, False, "under torchrun's 4 ranks"),
])
def test_ranks_to_start(data_parallel, cards, world, cpu, want):
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            dist_lib.ranks_to_start(data_parallel, cards, world, cpu)
    else:
        assert dist_lib.ranks_to_start(data_parallel, cards, world, cpu) == want


def test_train_cli_starts_its_ranks(tmp_path):
    """``tpu.data_parallel: 2`` with ``--device cpu`` and no torchrun: the
    CLI starts two gloo ranks itself, each trains, the chief logs and saves."""
    write_run_config(tmp_path)
    cfg = json.loads((tmp_path / "cfg.json").read_text())
    cfg["tpu"]["data_parallel"] = 2
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "smart_vocoder_torch.train", "-c", "cfg.json", "-m", "dp2",
         "--max-steps", "3", "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    model_dir = tmp_path / "logs" / "dp2"
    log = (model_dir / "train.log").read_text()
    assert "torch.distributed gloo: rank 0 of 2 on cpu" in log
    steps = [json.loads(ln.split("\t")[-1])[5] for ln in log.splitlines()
             if ln.split("\t")[-1].startswith("[")]
    assert steps == [0, 1, 2]
    assert sorted(p.name for p in model_dir.glob("*.pth")) == ["D_2.pth", "D_3.pth",
                                                                  "G_2.pth", "G_3.pth"]


def test_a_failing_rank_fails_the_cli(tmp_path, monkeypatch):
    """Both spawned ranks stop at a config the loop refuses (a
    ``train.batch_size`` that ``tpu.model_parallel`` does not divide): the CLI
    raises (a non-zero exit from the command line)."""
    from smart_vocoder_torch import train

    write_run_config(tmp_path)
    cfg = json.loads((tmp_path / "cfg.json").read_text())
    cfg["train"]["batch_size"] = 3
    cfg["tpu"].update(data_parallel=1, model_parallel=2)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(mp.ProcessRaisedException, match="model_parallel"):
        train.main(["-c", "cfg.json", "-m", "bad", "--device", "cpu"])

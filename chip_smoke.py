"""Smoke run of the PyTorch port on one NVIDIA H100: the serving paths, the
training-kernel A/B, the packed-MRF variants, the GAN train step, the
training runtime, the data axis and the model axis (on every card where
there are several), the headline entry point, and the training-evidence
tools (a short speaker-conditioned convergence run and its samples).

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: a CUDA card is required; prints its name and power limit.
2. build: compiles the CUDA kernels (smart_vocoder_torch/kernels/csrc) with
   nvcc for sm_90a into smart_vocoder_torch/_build/, and counts the MMA
   instructions in the SASS of every bf16 instantiation of the tensor-core
   kernels: the two stages, the unpacked stage's pair (and its replay mode),
   the WN stack (``wgmma`` from 64 channels, ``mma.sync`` at 32), and the
   branch backward's dx step (the same) and weight-gradient GEMM
   (``mma.sync``).
3. kernels: each kernel against its plain PyTorch version on the card (TF32
   off), at the main-path shapes -- stage 3 x (2, 128000, 64), stage 4
   u (2, 128000, 64) with the conv_post tail; the WN stack at x (32, 1000,
   192) with the 16 prior layers (bf16: each launch of 4 layers on the
   plain version's own state and skip sum; f32, the FMA route: the whole
   stack); the unpacked MRF stage at x (2, 64000, 128) and (1, 8192, 256)
   in bf16 (each faster than its plain version; the f32 FMA route timed at
   the same shape) and a ragged length in bf16 and f32; its F32_STORAGE mode
   (hifi >= 2's stages 1-2) at the batch and live cells' stage shapes,
   (32, 8192 | 3072, 256) and (32, 65536 | 24576, 128), and two ragged
   lengths, each faster than the cuDNN ``mixed_f32`` route it replaces; the stage-3
   fold-up u (2, 64000, 128) -> (2, 128000, 64) -- in the modes the serving
   paths use (stage 3: f32_storage, bf16, x2; stage 4: hifi, bf16), plus
   ragged lengths, and the two stages' f32 FMA route on true-f32 inputs and
   weights; the options of the packed-MRF variants
   (``mask_edges=False``, the bf16 output of f32_storage) at the stage-3
   shapes; the Triton gate at x (32, 1000, 384) with g (32, 1, 384) and
   without, and ragged; the MRF branch backward for k = 3, 7, 11 at the
   training shapes (16, 256, 256), (16, 2048, 128), (16, 4096, 64), (16, 8192,
   32) and a ragged length, in f32 (the FMA body) and in bf16 (the tensor-core
   kernels, and only they): the kernel's replay against the plain replay,
   and its gradients against the plain backward on that same replay (the
   leaky derivative jumps at 0, so on separate replays one value within
   rounding noise of 0 moves a gradient entry by a whole term); the bf16
   backward must beat the FMA route at each training shape.
4. slice: iitp_base at full width, weights from the port's seeded init,
   ``Vocoder.mel_to_wav`` on B=8 x 1000 frames plus one short request padded
   to the bucket, each path with the launch counts reset just before it:
   ``Vocoder(dtype=bf16, hifi=2)`` (mel-L1 against the port's plain f32 path
   <= 1e-2), hifi 0 (<= 5e-2), hifi 0 with ``use_wn_kernels`` (<= 5e-2),
   hifi 2 with it (printed: the reference's bf16-prior combination), and
   ``decoder_apply(pallas_stage2=True)`` on the hifi-0 path's prior latent
   (<= 5e-2), plus one 1024-frame request that routes stage 1 (256
   channels) to the unpacked kernel; each path's kernels must have launched
   (hifi 2: stages 1-2 on the F32_STORAGE pair kernel too, 18 launches a
   call), and no f32 FMA body (``*_fma``) on any of them.
5. timing: B=32 x 1000 frames (bench.py's protocol: warm-up, iterations,
   synchronize) for hifi 2, hifi 0, hifi 0 + WN kernels, the pallas_stage2
   route (weights packed once by ``pack_decoder``) and the plain f32 path,
   each with its launches per step checked (the WN and stage-2 paths: the
   tensor-core bodies), and a profiler breakdown of the hifi-2 step by
   kernel and of the two WN / stage-2 paths.
6. gate path: the 16 gates of the prior's WN layers under a speaker
   conditioning, x (32, 1000, 384) + g (32, 1, 384) each, through
   ``fused_gate``, against the module graph's ``gated_activation``.
7. training-kernel A/B at full width (``tools/ab_mrf_train.py``): B = 16,
   the four training shapes, bf16, ``mean(|stage(x)|)``; forward + backward
   of cuDNN autograd against ``mrf_stage_train`` (forward and backward on the
   tensor cores, weights packed per call; no ``*_fma`` launch), interleaved.
8. variants (``tools/exp_mrf_variants.py``): stage 3, x (32, 128000, 64).
9. live serving at full width. The prior noise on the card against the CPU
   (``ops.noise``: Philox words equal, normals within 1e-6). iitp_base hifi 2
   bf16: ``mel_to_wav_chunked`` of a 6000-frame utterance at 1024:128 against
   ``mel_to_wav`` of the whole with the same ``positional_eps`` (mel-L1 <=
   1e-3) and against the plain f32 path's chunked decode (<= 1e-2);
   ``stream_mel_to_wav`` over ragged pieces equal to the chunked decode bit
   for bit; hifi 0 + WN kernels chunked (launches only). ``StreamServer`` at
   384:96, 8 rows, on iitp_base_ms (109 speakers): eight streams of 800-1600
   frames with mixed seeds, sids and noise scales; one stream bit-identical
   alone and among other co-tenants in another row; each stream against its
   B = 1 ``stream_mel_to_wav`` (mel-L1 <= 1e-3). Every window and server
   step is a replay of its program's CUDA graph (``programs.py``), made by
   ``warmup`` before the counted paths; each of these paths runs with the
   counts reset just before it: a hifi-2 call's stage kernels a window or
   server step (stages 3-4 once, 18 F32_STORAGE pair launches; a replay adds
   its capture's tally), no ``*_fma``. The
   programs: (a) replays bit-equal to the eager launches on the same buffers
   (``tools/bench_streaming.py:eager_window``, ``eager_decode``) for windows
   of 1024 and 384 frames at hifi 2 and on the hifi-0 + WN route, and for
   an 8-row server step on iitp_base_ms with mixed sids and noise scales;
   (b) a profiler trace of one replay of a 384-frame window (hifi 2; the WN
   route, with 12 ``wn_stack`` kernels) and of the server's step: one
   ``up_mrf_stage`` and one ``mrf_stage`` kernel each, the card's busy
   share, the top kernels; (c) graph against eager ms, ``ROUNDS``
   interleaved rounds (``time_legs``), windows at 1024:128, 384:96, 256:64
   and server decodes of 1, 8, 32 rows; (d) ``warmup()`` of every default
   bucket (64-4096 frames) on a fresh ``Vocoder``: capture ms a shape, the
   reserved MB before and after, the graph pool's MB. Voice conversion on
   iitp_base_ms in f32, B = 2 x 400 frames: the same speaker recovers z
   within 1e-4 of its largest entry; another gives finite waveforms in
   [-1, 1] that differ. Timing: ``tools/bench_streaming.py`` in a fresh
   process (first window cold -- the program's making included -- against
   after ``warmup``, the B = 1 operating points, the N = 1, 8, 32 stream
   sweep, each graph time beside its eager one), each table with the card's
   name and power limit.
10. the train step (``training.make_train_step``) at full width: iitp_base,
   B = 16 x 1000 frames, segment 8192 samples, seeded G and D. The f32 and
   the bf16 step from the same weights and the same explicit noise (each of
   the five losses of the bf16 step within rel ``BF16_LOSS_REL`` of the f32
   step's), every metric finite, no kernel of the port launched (the step
   differentiates the module graph, as JAX's does); a second bf16 step in
   which D after the step equals D after its own optimizer step (the G
   phase moves none of its parameters) and after which every G and D
   parameter has moved; 10 steps on one batch lower ``loss/g/mel``; one
   conditioned step on iitp_base_ms; one bf16 step under the profiler (top
   kernels, and the decoder MRF convolutions' share of the card's busy
   time, forward and backward); then ``tools/bench_train.py``'s bf16 and
   f32 legs (step ms as the median of 5 interleaved rounds with its range,
   steps/s, audio x real time, busy share, peak memory, TFLOP/s against the
   5.58 TFLOP model count).
11. the training runtime, on a synthetic corpus (``tools/make_corpus.py``:
   96 mono PCM16 harmonic tones of 345-1000 frames, every iitp_base bucket
   from 300 to 1000 used, 7 batches an epoch) with iitp_base bf16, B = 16,
   segment 8192, ``eval_interval`` 20, ``keep_ckpts`` 2. Run A: ``python -m
   smart_vocoder_torch.train --max-steps 40`` in a subprocess (a loss line
   every step, all finite; ``eval/mel_l1`` at steps 0 and 20; pairs 20 and
   40 kept). A's step-20 pair restored in this process equals the files bit
   for bit (G, D, both AdamW states; step and epoch). Run B resumes from that
   pair in a second process, in a 1-rank NCCL group (torchrun's variables
   set in its environment: the resume check, the gradients and the metrics
   go through NCCL's all-reduce), and runs to 40: its first step's five losses
   within rel ``RESUME_LOSS_REL`` of A's (printed: whether bit-equal, and
   each later step's drift); its last ``G_*.pth`` loads strictly into a fresh
   ``SynthesizerTrn``. Timing, in this process (``LoopProbe``): 30 steps at
   ``log_interval`` 5, then the same with ``tpu.cache_specs`` on: the loop's
   step ms (median and range from step 5, the eval/save step left out), how
   long ``next()`` on the loader blocks, the host's build of an item, its
   collation and pinning, eval and save ms, the pair's size, peak memory,
   audio trained a wall second from the first batch in hand to the last
   (evals and saves included; beside it the same over the steady steps);
   20 steps with steps 10-19 under the loop's ``StepProfiler`` (the card's
   busy share from its Chrome trace); an isolated bf16 step with cuDNN's
   algorithm search off, as the loop runs, beside phase 10's
   ``tools/bench_train.py``. A conditioned run of 5 steps on iitp_base_ms
   from ``path|sid`` lists. The corpus and runs live in a temporary
   directory, removed at the end. Every config of the phase pins
   ``tpu.data_parallel: 1``: one process on one card, on any machine.
12. the data axis (``Vocoder(devices=...)``, iitp_base hifi 2 bf16, the
   phase-4 weights). The checks run on cuDNN's heuristic plans (its timed
   search keeps its choices per thread, and each device's shards run on a
   thread of their own), the timing with the search on, as phase 5. (a) Two
   shards on ``cuda:0``, B = 32 x 1000 with
   ``seed=`` noise: a hifi-2 call's stage kernels a shard (counts reset just
   before), each 16-row shard bit-equal to the one-device ``Vocoder``'s
   decode of its rows (the noise split with them), the 32 rows within mel-L1
   1e-3 of the one-device 32-row decode and 1e-2 of the f32 path; host ms a
   ``mel_to_wav`` call of both, 5 interleaved rounds, with x real time and
   TFLOP/s of ``utils.flops.synthesis_flops``. (b) Where there are two cards
   or more: ``data_devices()`` at B = 32 x cards, each card's shard within
   mel-L1 1e-3 of ``cuda:0``'s decode of its rows (largest sample difference
   printed), the aggregate x real time beside one card's and the scaling;
   then the ``train`` CLI without torchrun at
   ``tests/test_torch_distributed.py:write_run_config``'s tiny config,
   ``tpu.data_parallel: -1``, 3 steps: one NCCL rank per card, finite losses.
   With one card (b) prints that it was not run.
13. the model axis (``tpu.model_parallel``; ``tools/bench_model_axis.py``):
   iitp_base bf16 at full width from the seeded init (seed 1234), phase 10's
   batch of 16 x 1000 frames with the draws passed in. JAX's shard rule at
   M = 2 must take 343 of G's 639 tensors and 48 of D's 111; each leg's
   optimizer state must be the MB its shapes give at its M (~717 at M = 1,
   ~362 at M = 2). The checks run with cuDNN's search off, the timing with it
   on. (a) one process on ``cuda:0``, twice from the same weights: the
   card's run-to-run drift of the five losses (steps 1-3 and the last timed
   step) and of the parameters. With two cards or more, through
   ``parallel.dist.start_ranks`` (one NCCL rank a card, results through
   files): (b) D = 1 x M = 2, 8 rows a card: step 1's five losses within
   rel 1e-4 of (a)'s, or of (a)'s own drift if larger. With four: (c) D = 2 x
   M = 2 against D = 4 x M = 1 on the same 4 rows a card, 3 steps with
   ``cudnn.deterministic`` and ``torch.use_deterministic_algorithms`` on
   (warning only): the parameters bit-equal, or, where D = 4 x M = 1 does
   not repeat itself either, the largest differences printed with that
   cause and the ops that warned; (d) D = 4 x M = 1 with phase 10's 16 rows on each card: the
   step across cards, its x real time against (a)'s and the scaling. Every
   leg prints its optimizer MB a card, peak memory, step ms (median of 5
   interleaved rounds with its range), busy share (the kernels apart from
   NCCL's, which run on their own stream and wait inside the kernel; NCCL's
   ms beside it) and the card. With one card (b)-(d) print why they did not run.
14. the headline entry point: ``python -m smart_vocoder_torch.bench --iters
   10 --no-train`` in a fresh process (cuDNN's search as the entry point
   leaves it), on the JAX package's fidelity weights rebuilt in numpy
   (``utils/golden.py``): hifi 2 and hifi 0 at B = 32 x 1000, each the mean
   of 10 calls after 3, and mel-L1 against the golden fixture's torch
   reference of the f32 path (TF32 off, <= 1e-4) and of the timed path
   (<= 7e-3), under the reported ``fidelity_target`` of 1e-2;
   ``rtf_fast_bf16`` present. First the recipe's mel and noise
   (``fidelity_inputs``) against the fixture's, within 1e-4. Its JSON line is
   printed, prefixed, before the kernels' record.
15. the training-evidence tools: ``tools/make_synth_data.py --ms`` (64
   clips, 4 speakers), ``python -m smart_vocoder_torch.train`` on its config
   (iitp_base conditioned, full width, bf16, B = 16, segment 8192) for 200
   steps in a subprocess, its ``train.log`` read by
   ``tools/report_convergence.py``'s parser (the table printed; a finite row
   every 20 steps, an eval at step 0; mel and KL of the step-180 row under
   ``MS_MEL_BOUND`` and ``MS_KL_BOUND``, JAX's step-200 reading beside each),
   then ``tools/make_ms_samples.py`` on the step-200 ``G_*.pth`` for 2
   validation clips x sids 0 and 2: one launch each of ``up_mrf_stage`` and
   ``mrf_stage`` a call (counts reset before each) and no other kernel,
   finite mel-L1, the two sids' audio different. Prints its wall.
16. BigVGAN-v2 at its published widths (``model.kind: "bigvgan"``, weights
   from the benchmark's seeded rule): the fused anti-aliased SnakeBeta
   (``aa_snake``) against torch's chain in f32 at every stage shape of a B =
   32 call on the 1024 bucket, (32, 768, 4096) ... (32, 24, 262144), on f32
   and bf16 input, within one bf16 rounding, each timed beside the chain;
   one ``Vocoder.mel_to_wav`` at the cell's shapes with the launch counts
   reset just before it: 109 ``aa_snake`` launches and no other kernel, and
   mel-L1 against the plain reference (``vocbench/reference/bigvgan.py``)
   under the cell's limit.

Every kernel's record carries its bound: the larger of its operations over
the card's peak for their type (989 TFLOP/s, bf16 tensor cores: every conv
operand is a bf16 value, or a hi/lo pair of them in the F32 modes, which
then count two passes) and its bytes (inputs read once, outputs written once)
over 3.35 TB/s. No single PyTorch call computes an 18-conv stage, a WN stack,
a branch backward or the gate, so ``library_ms`` is null there; for
``aa_snake`` it is torch's chain (pad, grouped transposed conv, crop,
SnakeBeta's elementwise ops, pad, grouped conv), whose bound counts the
activation's f32 arithmetic over the 67 TFLOP/s f32 peak.
``tflops`` is the record's operations over its kernel time. Times: each
timed call runs beside its plain version (and the kernel it replaced) in
``ROUNDS`` interleaved rounds of a few back-to-back calls timed with CUDA
events (``time_legs``); ``ms`` is the median over the rounds, ``ms_min`` and
``ms_max`` its range, and for a call under 2 ms ``card_ms`` (with its range)
is the card's busy time per call under ``torch.profiler``, which leaves out
what the host spends launching. ``earlier_ms``, for the five kernels and the
variant that moved to the tensor cores, is the time measured in this run of
the f32 FMA kernel they replaced (today's route for true-f32 weights,
counted under its own ``*_fma`` name) at the same shape on f32 inputs; null
for the gate. The timed calls pass the weights packed once
(``pack_mrf_stage``, ``pack_up_mrf_stage``, ``pack_wn_stack``), as
``Vocoder`` does.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
HOP = 256
SR = 22050


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


ROUNDS = 5  # interleaved timing rounds of every measured call


def event_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_legs(legs: dict, iters: int, rounds: int = ROUNDS) -> dict:
    """Each leg's device ms per call, as tools/ab_stage_mma.py times: one
    warm-up call each, then ``rounds`` interleaved rounds of ``iters`` calls
    (every other round in reverse order); {leg: (median, min, max)}."""
    import statistics

    import torch

    for fn in legs.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in legs}
    order = list(legs.items())
    for r in range(rounds):
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            times[name].append(event_ms(fn, iters))
    return {name: (statistics.median(v), min(v), max(v)) for name, v in times.items()}


def card_ms(fn, calls: int = 5, rounds: int = ROUNDS) -> tuple:
    """The card's busy ms per call of ``fn`` under torch.profiler (the device
    time of its kernels, whatever the host's launches cost), over ``rounds``
    profiles of ``calls`` calls: (median, min, max)."""
    import statistics

    import torch

    from smart_vocoder_torch.tools import device_busy_ms

    v = [device_busy_ms(lambda: [fn() for _ in range(calls)], torch.device("cuda")) / calls
         for _ in range(rounds)]
    return statistics.median(v), min(v), max(v)


def span(t: tuple) -> str:
    return f"{t[0]:.4f} ({t[1]:.4f}-{t[2]:.4f})"


def card_span(rec: dict) -> str:
    """A record's card time with its range, or why there is none."""
    if rec.get("card_ms") is None:
        return "card not profiled (2 ms or more)"
    return f"card {span((rec['card_ms'], rec['card_ms_min'], rec['card_ms_max']))}"


def kernel_times(kernel, plain, iters: int, earlier=None, profile: bool = False) -> dict:
    """A kernel record's times: the kernel, its plain version and, where given,
    the FMA kernel it replaced, interleaved (``time_legs``); the kernel's
    median with its min and max over the rounds, and, for a call under 2 ms
    (or with ``profile``), its card time from the profiler, which shows
    whether the host's launches bound the events' time."""
    legs = {"kernel": kernel, "plain": plain, **({"earlier": earlier} if earlier else {})}
    t = time_legs(legs, iters)
    rec = {"ms": t["kernel"][0], "ms_min": t["kernel"][1], "ms_max": t["kernel"][2],
           "rounds": ROUNDS, "plain_ms": t["plain"][0], "card_ms": None,
           "card_ms_min": None, "card_ms_max": None}
    if earlier:
        rec["earlier_ms"] = t["earlier"][0]
    if rec["ms"] < 2.0 or profile:
        rec["card_ms"], rec["card_ms_min"], rec["card_ms_max"] = card_ms(kernel)
    return rec


def compare(name, got, want, exact, mode_f32: bool, ulp_slack: bool = False) -> float:
    """Kernel output against its plain version. F32 modes: max |diff| <= 1e-3
    (f32 summation order; every value is a tanh output or O(1) activation).
    bf16-rounding modes: the two round at the same points, but summation
    order flips a rounding now and then and the chains carry it; the mean
    |diff| must stay under half, and the max under all, of what bf16 costs
    against the F32 result on the same inputs. ``ulp_slack`` (the unpacked
    stage and the WN stack, whose cost max can fall below one flip) lets the
    max reach one bf16 ulp of the largest output instead, the size of one
    flip; both bounds are printed."""
    import math

    import torch

    got, want, exact = got.float(), want.float(), exact.float()
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite kernel output")
    diff = (got - want).abs()
    err = diff.max().item()
    if mode_f32:
        ok = err <= 1e-3
        detail = f"max {err:.3e} <= 1e-3"
    else:
        cost = (want - exact).abs()
        top = want.abs().max().item()
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
        bound = max(cost.max().item(), ulp) if ulp_slack else cost.max().item()
        ok = diff.mean().item() < 0.5 * cost.mean().item() and err <= bound
        detail = (f"mean {diff.mean().item():.3e} vs bf16 cost {cost.mean().item():.3e}, "
                  f"max {err:.3e} vs bf16 cost max {cost.max().item():.3e}, ulp {ulp:.3e} "
                  f"({'larger of the two' if ulp_slack else 'cost max'} bounds)")
    log(f"  {name}: {detail} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version ({detail})")
    return err


def compare_f32(name, got, want, tol: float) -> float:
    """An f32 result against its plain version: max |diff| within ``tol`` of
    the largest entry (f32 summation order, which for the weight gradients the
    blocks' atomic adds change from run to run)."""
    import torch

    if got.shape != want.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: bad output")
    err, top = (got - want).abs().max().item(), want.abs().max().item()
    ok = err <= tol * top
    log(f"  {name}: max {err / top:.2e} of the largest entry (<= {tol:g}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return err


PEAK_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores (H100 SXM data sheet)
HBM_RATE = 3.35e12  # bytes/s


def bound(flops: float, tensors) -> dict:
    """The least time the card could take: operations over the bf16 peak
    against the bytes of ``tensors`` (each moved once) over the memory rate."""
    t_ops = flops / PEAK_BF16 * 1e3
    t_bytes = sum(t.numel() * t.element_size() for t in tensors) / HBM_RATE * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "flops": flops,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None}


TENSOR_CORE_KERNELS = ("up_mrf_stage_kernel", "mrf_stage_kernel", "mrf_pair_mma_kernel",
                       "mrf_pair_f32s_kernel", "wn_stack_mma_kernel", "mrf_pair_bwd_kernel",
                       "mrf_dw_mma_kernel")


def sass_mma_counts(so: str) -> dict:
    """MMA instructions in the built library's SASS (``cuobjdump -sass``), per
    instantiation of the tensor-core kernels (the two stages, the unpacked
    stage's pair and its replay mode, the WN stack, the backward's dx step and
    weight-gradient GEMM): {demangled-ish name: {"HGMMA": n, "HMMA": n,
    "FFMA": n}}, template arguments as numbers (a bool as 0 or 1). ``HGMMA`` is
    ``wgmma``, ``HMMA`` is ``mma.sync``."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    proc = subprocess.Popen([tool, "-sass", so], stdout=subprocess.PIPE, text=True)
    counts, current = {}, None
    for line in proc.stdout:
        if "Function :" in line:
            m = re.search(rf"\d+({'|'.join(TENSOR_CORE_KERNELS)})((?:I?L[ib]\d+E)+)", line)
            current = None
            if m:
                current = f"{m.group(1)}<{', '.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>"
                counts[current] = {"HGMMA": 0, "HMMA": 0, "FFMA": 0}
        elif current:
            for op in counts[current]:
                if f" {op}" in line:
                    counts[current][op] += 1
    if proc.wait() != 0:
        raise RuntimeError(f"cuobjdump failed on {so}")
    return counts


def mrf_flops(b: int, t: int, c: int, ks, n_pairs: int) -> float:
    """One MRF stage: 2 convs per residual pair per branch, 2*k*C*C FLOP a row."""
    return 2.0 * n_pairs * sum(2 * k for k in ks) * c * c * t * b


# The stage kernels of one hifi-2 call or step of iitp_base: stages 3-4 once
# each, and stages 1-2 (256 and 128 channels) in the unpacked kernel's
# F32_STORAGE mode, one launch per residual pair of each branch.
STAGE_KERNELS = {"mrf_stage": 1, "up_mrf_stage": 1}
HIFI2_KERNELS = {**STAGE_KERNELS, "mrf_stage_unpacked_f32s": 18}
# hifi >= 2's early-decoder MRF stages on the F32_STORAGE kernel: the batch
# cell's (32 x 1024 frames) and the live cell's (32 x 384) stages 1 and 2, and
# two ragged lengths
F32S_SHAPES = ((0, (32, 8192, 256)), (1, (32, 65536, 128)), (0, (32, 3072, 256)),
               (1, (32, 24576, 128)), (0, (3, 1234, 256)), (1, (3, 12345, 128)))


def unpacked_f32s_kernels(card: str, dev, stage_branches, ks, dil, rng) -> dict:
    """Phase 3's F32_STORAGE unpacked stage (``mrf_stage_unpacked(f32_storage=
    True)``) at ``F32S_SHAPES``: 9 launches a stage, weights packed once give
    the same bits, the result against its plain version (the bf16-rounding
    rule of ``compare``) and, at the cell shapes, the kernel's ms beside its
    bound, its plain version and the cuDNN route it replaces
    (``mrf_stage_reference(mixed_f32=True)``, TF32 off). Returns the record of
    the batch cell's stage 2."""
    import torch

    from smart_vocoder_torch.kernels import mrf as K

    out = {}
    for stage, shape in F32S_SHAPES:
        x = torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)).to(dev)
        br = stage_branches(stage, torch.bfloat16)
        tag = f"mrf_stage_unpacked {shape} f32_storage"
        before = K.LAUNCHES["mrf_stage_unpacked_f32s"]
        got = K.mrf_stage_unpacked(x, br, ks, dil, f32_storage=True)
        if K.LAUNCHES["mrf_stage_unpacked_f32s"] != before + len(ks) * len(dil):
            raise RuntimeError(f"{tag}: did not take mrf_stage_unpacked_f32s")
        packed = K.pack_mrf_stage(br, dev)
        if not torch.equal(got, K.mrf_stage_unpacked(x, br, ks, dil, f32_storage=True,
                                                     packed=packed)):
            raise RuntimeError(f"{tag}: weights packed once give other bits")
        want = K.mrf_stage_plain(x, br, ks, dil, K.F32_STORAGE)
        exact = K.mrf_stage_plain(x, br, ks, dil, K.F32)
        err = compare(tag, got, want, exact, False, ulp_slack=True)
        del want, exact
        if shape[0] == 32:
            times = kernel_times(
                lambda: K.mrf_stage_unpacked(x, br, ks, dil, f32_storage=True, packed=packed),
                lambda: K.mrf_stage_plain(x, br, ks, dil, K.F32_STORAGE), 2,
                earlier=lambda: K.mrf_stage_reference(x, br, ks, dil, mixed_f32=True))
            ms = times["ms"]
            bnd = bound(mrf_flops(*shape, ks, len(dil)), [x, got, *sum(br, ())])
            log(f"  {tag}: kernel {ms:.3f} ms ({times['ms_min']:.3f}-{times['ms_max']:.3f}; "
                f"{bnd['flops'] / ms / 1e9:.1f} TFLOP/s), plain {times['plain_ms']:.2f} ms, "
                f"bound {bnd['bound_ms']:.3f} ms ({bnd['bound_by']}), cuDNN mixed_f32 route "
                f"{times['earlier_ms']:.2f} ms  [{card}]")
            if not ms < times["earlier_ms"]:
                raise RuntimeError(f"{tag}: the kernel is not faster than the cuDNN route")
            out[str(shape)] = {"max_abs_err": err, **times, **bnd}
        del x, got
    return out


def profile_step(label: str, fn, card: str, rows: int) -> None:
    """One step under torch.profiler: wall, device-busy share, top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # device-side events only: an aten op's row repeats its kernels' time
    busy_ms = sum(e.self_device_time_total for e in averages
                  if e.device_type == DeviceType.CUDA) / 1e3
    log(f"profiled {label} step: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%)  [{card}]")
    table = averages.table(sort_by="self_device_time_total", row_limit=rows)
    log(f"profile ({label}, one step, top kernels by device time):")
    for line in table.splitlines():
        log("  " + line)


LIVE_FRAMES = 6000       # ~70 s of audio
LIVE_POINT = (1024, 128)
SERVER_POINT = (384, 96)
SERVER_ROWS = 8
WINDOW_POINTS = ((1024, 128), (384, 96), (256, 64))  # tools/bench_streaming.py's
SWEEP_ROWS = (1, 8, 32)
# the kernels of a replay by the name in the profiler's trace (a lookbehind
# keeps up_mrf_stage_kernel out of mrf_stage_kernel's count)
TRACE_KERNELS = {"up_mrf_stage": r"up_mrf_stage_kernel", "mrf_stage": r"(?<!\w)mrf_stage_kernel",
                 "wn_stack": r"wn_stack_mma_kernel",
                 "mrf_stage_unpacked_f32s": r"mrf_pair_f32s_kernel"}


def replay_trace(label: str, fn, want: dict, card: str, rows: int = 8) -> float:
    """One call of ``fn`` (a program's replay and its copies) under
    torch.profiler: each kernel of ``TRACE_KERNELS`` launched as often as
    ``want`` says (0 where it is not named), the top kernels, and the card's
    busy share: its busy ms in the trace over the call's unprofiled wall
    (the median of 5 calls; the profiler slows the host). Returns the share."""
    import re
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in averages) / 1e3
    seen = {k: sum(e.count for e in averages if re.search(pat, e.key))
            for k, pat in TRACE_KERNELS.items()}
    want = {k: want.get(k, 0) for k in TRACE_KERNELS}
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    share = busy_ms / statistics.median(walls)
    log(f"replay trace, {label}: card busy {busy_ms:.3f} ms in "
        f"{sum(e.count for e in averages)} kernels; the call's wall {statistics.median(walls):.3f} "
        f"ms unprofiled (median of 5), {wall_ms:.3f} ms profiled; busy share "
        f"{100 * share:.1f}%; stage and WN kernels {seen} (expected {want})  [{card}]")
    for e in sorted(averages, key=lambda e: -e.self_device_time_total)[:rows]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:4d}x  {e.key[:100]}")
    if seen != want:
        raise RuntimeError(f"replay trace, {label}: kernels {seen}, expected {want}")
    return share


def graph_pool_mb(vocoder) -> float | None:
    """MB the CUDA caching allocator holds in ``vocoder``'s graph pool (its
    segments in ``torch.cuda.memory_snapshot()``); None where the snapshot
    does not name a segment's pool."""
    import torch

    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    pool = tuple(vocoder._graph_pool)
    return sum(g["total_size"] for g in segments
               if tuple(g["segment_pool_id"]) == pool) / 2 ** 20


def live_programs(vocoder_hifi2, vocoder_wn0, voc_ms, card: str, rng) -> None:
    """Phase 9's serving programs: (a) each window and server step replayed
    bit-equal to its eager launches on the same buffers; (b) a profiler trace
    of one replay; (c) graph against eager ms, interleaved; (d) capture ms a
    shape and the graph pool's MB after ``warmup`` of every bucket."""
    import torch

    from smart_vocoder_torch.inference import Vocoder
    from smart_vocoder_torch.serving import StreamServer
    from smart_vocoder_torch.tools.bench_streaming import eager_decode, eager_window, ready_server

    t_part = time.perf_counter()
    n_mels = vocoder_hifi2.hps.data.n_mel_channels
    stages = HIFI2_KERNELS
    wn = {"wn_stack": 12, **STAGE_KERNELS}

    # (a) graph against eager, bit for bit
    for label, voc in (("hifi 2", vocoder_hifi2), ("hifi 0 + WN kernels", vocoder_wn0)):
        for chunk, overlap in (LIVE_POINT, SERVER_POINT):
            for lo, n in ((0, chunk), (5 * chunk + 7, chunk - overlap - 11)):
                mel = (rng.normal(0, 1, (n, n_mels)) * 2.0 - 4.0).astype(np.float32)
                graph = voc._synth_window(mel, lo, chunk, 0.667, None, SEED + lo)
                eager = eager_window(voc, mel, lo, chunk, 0.667, None, SEED + lo)
                if not (np.isfinite(graph).all() and np.array_equal(graph, eager)):
                    raise RuntimeError(f"window program {label} {chunk}:{overlap} (lo {lo}, "
                                       f"{n} frames): replay differs from the eager launches, "
                                       f"max |diff| {np.abs(graph - eager).max():.3e}")
        log(f"live programs (a): {label} windows at {LIVE_POINT[0]} and {SERVER_POINT[0]} "
            f"frames, a full and a short one each: replay = eager launches bit for bit")
    chunk, overlap = SERVER_POINT
    server = StreamServer(voc_ms, max_streams=SERVER_ROWS, chunk=chunk, overlap=overlap)
    for i in range(SERVER_ROWS - 2):  # two idle rows
        h = server.open(seed=SEED + 50 + i, sid=int(rng.integers(0, voc_ms.hps.data.n_speakers)),
                        noise_scale=(0.667, 1.0, 0.3)[i % 3])
        server.feed(h, (rng.normal(0, 1, (chunk + 40 * i, n_mels)) * 2.0 - 4.0)
                    .astype(np.float32))
    server.step()
    ready = [(h, s) for h, s in server._streams.items()
             if s.ready(server.step_frames, overlap)]
    if len(ready) < 2:
        raise RuntimeError(f"server program: {len(ready)} windows ready")
    for (_, _, g), (_, _, e) in zip(server._decode_batch(ready), eager_decode(server, ready)):
        if not np.array_equal(g, e):
            raise RuntimeError("server program: replay differs from the eager launches")
    log(f"live programs (a): iitp_base_ms {SERVER_ROWS}-row server at {chunk}:{overlap}, "
        f"{len(ready)} windows past frame 0 (mixed sids and noise scales, idle rows): "
        "replay = eager launches bit for bit")

    # (b) one replay under the profiler
    mel = (rng.normal(0, 1, (chunk, n_mels)) * 2.0 - 4.0).astype(np.float32)
    busy = {
        "window 384 hifi 2": replay_trace(
            f"B = 1 window {chunk}:{overlap} (iitp_base hifi 2)",
            lambda: vocoder_hifi2._synth_window(mel, 0, chunk, 0.667, None, SEED), stages, card),
        "window 384 hifi 0 + WN": replay_trace(
            f"B = 1 window {chunk}:{overlap} (iitp_base hifi 0 + WN kernels)",
            lambda: vocoder_wn0._synth_window(mel, 0, chunk, 0.667, None, SEED), wn, card),
        "server 8 rows": replay_trace(
            f"StreamServer {SERVER_ROWS}-row decode {chunk}:{overlap} (iitp_base_ms hifi 2)",
            lambda: server._decode_batch(ready), stages, card)}
    del server

    # (c) graph against eager, interleaved: B = 1 windows and server decodes
    legs = {}
    for chunk, overlap in WINDOW_POINTS:
        mel = (rng.normal(0, 1, (chunk, n_mels)) * 2.0 - 4.0).astype(np.float32)
        legs[f"window {chunk}:{overlap} graph"] = (
            lambda m=mel, c=chunk: vocoder_hifi2._synth_window(m, 0, c, 0.667, None, SEED))
        legs[f"window {chunk}:{overlap} eager"] = (
            lambda m=mel, c=chunk: eager_window(vocoder_hifi2, m, 0, c, 0.667, None, SEED))
    chunk, overlap = SERVER_POINT
    for n in SWEEP_ROWS:
        server, ready = ready_server(vocoder_hifi2, n, chunk, overlap, rng)
        legs[f"server {n} rows graph"] = lambda s=server, r=ready: s._decode_batch(r)
        legs[f"server {n} rows eager"] = lambda s=server, r=ready: eager_decode(s, r)
    times = time_legs(legs, iters=3)
    log(f"live programs (c): ms a call, graph against eager, median of {ROUNDS} interleaved "
        f"rounds of 3 (CUDA events; each call ends in its copy to the host), iitp_base hifi 2 "
        f"bf16  [{card}]")
    for name in list(legs)[::2]:
        g, e = times[name], times[name.replace("graph", "eager")]
        log(f"  {name[:-6]:>22}: graph {span(g)}, eager {span(e)}, eager / graph "
            f"{e[0] / g[0]:.2f}")

    # (d) capture ms a shape; the graph pool after warmup of every bucket
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    pooled = Vocoder(vocoder_hifi2.hps, vocoder_hifi2.params, dtype=torch.bfloat16, hifi=2,
                     device=vocoder_hifi2.device)
    t0 = time.perf_counter()
    pooled.warmup()
    wall = time.perf_counter() - t0
    after = torch.cuda.memory_reserved()
    pool_mb = graph_pool_mb(pooled)
    log(f"live programs (d): warmup() of the {len(pooled.buckets)} buckets "
        f"{pooled.buckets} at hifi 2 in {wall:.2f} s; reserved {before / 2 ** 20:.1f} -> "
        f"{after / 2 ** 20:.1f} MB, the graph pool "
        f"{'not measured' if pool_mb is None else f'{pool_mb:.1f} MB'}  [{card}]")
    for voc, label in ((pooled, "hifi 2, every bucket"), (vocoder_hifi2, "hifi 2"),
                       (vocoder_wn0, "hifi 0 + WN"), (voc_ms, "iitp_base_ms hifi 2")):
        log(f"  capture ms, {label}: " + ", ".join(f"{k} {p.capture_ms:.1f}"
                                                   for k, p in voc._programs.items()))
    pooled.close()
    log("  replay busy shares: " + ", ".join(f"{k} {100 * v:.1f}%" for k, v in busy.items()))
    log(f"live programs (a)-(d): {time.perf_counter() - t_part:.1f} s")


def live_path(label: str, run, per_call: dict, calls) -> object:
    """Drive one live path with the counts reset just before it and read them
    just after: each kernel of ``per_call`` launched that many times per
    window or server step (``calls()`` of them, read after the run), and
    nothing else, no ``*_fma`` body in particular."""
    import torch

    from smart_vocoder_torch.kernels import LAUNCHES, reset_launch_counts

    reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    counts = {k: v for k, v in LAUNCHES.items() if v}
    n = calls()
    want = {k: v * n for k, v in per_call.items()}
    log(f"live {label}: {n} windows/steps, launches {counts}")
    if counts != want:
        raise RuntimeError(f"{label}: launches {counts}, expected {want}")
    return out


def windows(t: int, chunk: int, overlap: int) -> int:
    """Windows ``mel_to_wav_chunked`` cuts from t frames."""
    step = chunk - 2 * overlap
    return 1 if t <= step else -(-t // step)


def live_serving(vocoder_hifi2, vocoder_f32, vocoder_wn0, mel_l1, card: str, rng) -> None:
    """Phase 9: the windows, the stream, the server and voice conversion at
    full width, then the timing tool in a fresh process."""
    import torch

    from smart_vocoder_torch.config import load_config
    from smart_vocoder_torch.inference import Vocoder
    from smart_vocoder_torch.models import build_synthesizer
    from smart_vocoder_torch.ops import positional_eps, spectrogram
    from smart_vocoder_torch.ops.noise import philox4x32
    from smart_vocoder_torch.serving import StreamServer
    from smart_vocoder_torch.utils.init import init_synthesizer

    dev = vocoder_hifi2.device
    hps = vocoder_hifi2.hps
    n_mels, inter = hps.data.n_mel_channels, hps.model.inter_channels
    stages = HIFI2_KERNELS  # the stage kernels' launches a window or step

    # the noise: the same Philox words on the card as on the CPU; the normals
    # within 1e-6 (float64 log/cos/sin, rounded once to float32)
    frame = torch.arange(LIVE_FRAMES, dtype=torch.int64)[:, None] + 2 ** 33 - 100
    block = torch.arange(inter // 4, dtype=torch.int64)[None, :]
    words = [philox4x32([frame & 0xFFFFFFFF, frame >> 32, block, torch.tensor(0)],
                        [torch.tensor(SEED), torch.tensor(7)]) for frame, block in
             ((frame, block), (frame.to(dev), block.to(dev)))]
    if not all(torch.equal(a, b.cpu()) for a, b in zip(*words)):
        raise RuntimeError("positional noise: Philox words differ between the CPU and the card")
    e_card = positional_eps([SEED, 7], [0, 2 ** 33], LIVE_FRAMES, inter, dev)
    err = (e_card.cpu() - positional_eps([SEED, 7], [0, 2 ** 33], LIVE_FRAMES, inter)).abs().max()
    log(f"live noise: {tuple(e_card.shape)} on the card vs the CPU: words equal, normals max "
        f"|diff| {err.item():.2e} (<= 1e-6)")
    if not err <= 1e-6:
        raise RuntimeError("positional noise: the card's normals differ from the CPU's")

    # chunked against whole, iitp_base hifi 2 bf16
    chunk, overlap = LIVE_POINT
    mel = (rng.normal(0, 1, (LIVE_FRAMES, n_mels)) * 2.0 - 4.0).astype(np.float32)
    n_win = windows(LIVE_FRAMES, chunk, overlap)
    kw = dict(chunk=chunk, overlap=overlap, noise_scale=0.667, seed=SEED)
    # the window programs (capture counted as no launch; the eager call before
    # it as one) made before the paths whose launches are counted
    vocoder_hifi2.warmup([chunk])
    vocoder_wn0.warmup([chunk])
    chunked = live_path("chunked hifi 2", lambda: vocoder_hifi2.mel_to_wav_chunked(mel, **kw),
                        stages, lambda: n_win)
    eps = positional_eps([SEED], [0], LIVE_FRAMES, inter).numpy()
    whole = vocoder_hifi2.mel_to_wav(mel[None], eps=eps)[0]
    f32 = vocoder_f32.mel_to_wav_chunked(mel, **kw)
    for w in (chunked, whole, f32):
        if w.shape != (LIVE_FRAMES * HOP,) or not np.isfinite(w).all() or np.abs(w).max() > 1:
            raise RuntimeError(f"live: bad waveform {w.shape}")
    l1_whole, l1_f32 = mel_l1([chunked], [whole]), mel_l1([chunked], [f32])
    log(f"live chunked {LIVE_FRAMES} frames at {chunk}:{overlap}, hifi 2 bf16: vs the whole "
        f"utterance (same positional noise) mel-L1 {l1_whole:.6f} (<= 1e-3), max |diff| "
        f"{np.abs(chunked - whole).max():.3e}; vs the plain f32 path chunked mel-L1 "
        f"{l1_f32:.6f} (<= 1e-2)")
    if not (l1_whole <= 1e-3 and l1_f32 <= 1e-2):
        raise RuntimeError("live chunked: mel-L1 above its bound")

    # the stream over ragged pieces: the same windows, so the same bits
    cuts = np.cumsum(rng.integers(1, 400, LIVE_FRAMES))
    cuts = [0] + [int(c) for c in cuts[cuts < LIVE_FRAMES]] + [LIVE_FRAMES]
    pieces = [mel[a:b] for a, b in zip(cuts, cuts[1:])]
    streamed = live_path("stream hifi 2", lambda: np.concatenate(list(
        vocoder_hifi2.stream_mel_to_wav(iter(pieces), **kw))), stages, lambda: n_win)
    log(f"live stream: {len(pieces)} ragged pieces, equal to the chunked decode bit for bit: "
        f"{np.array_equal(streamed, chunked)}")
    if not np.array_equal(streamed, chunked):
        raise RuntimeError("live stream: differs from the chunked decode")

    # the WN route's windows (hifi 0 + use_wn_kernels): 12 WN launches a window
    short = mel[:2000]
    wn = live_path("chunked hifi 0 + WN kernels",
                   lambda: vocoder_wn0.mel_to_wav_chunked(short, **kw),
                   {"wn_stack": 12, **STAGE_KERNELS},
                   lambda: windows(len(short), chunk, overlap))
    log(f"live chunked hifi 0 + WN kernels: mel-L1 vs the plain f32 path chunked "
        f"{mel_l1([wn], [f32[:len(wn)]]):.5f} (printed)")

    # the multi-stream server on the speaker-conditioned config
    hps_ms = load_config(os.path.join(ROOT, "configs", "iitp_base_ms.json"))
    state_ms = {k: v.detach() for k, v in
                init_synthesizer(build_synthesizer(hps_ms), SEED).state_dict().items()}
    voc_ms = Vocoder(hps_ms, state_ms, dtype=torch.bfloat16, device=dev)
    chunk, overlap = SERVER_POINT
    specs = [dict(seed=SEED + i, sid=int(rng.integers(0, hps_ms.data.n_speakers)),
                  noise_scale=(0.667, 1.0)[i % 2]) for i in range(SERVER_ROWS)]
    mels = [(rng.normal(0, 1, (int(rng.integers(800, 1601)), n_mels)) * 2.0 - 4.0)
            .astype(np.float32) for _ in specs]

    def ragged(m):
        cut = np.cumsum(rng.integers(20, 120, len(m)))
        cut = [0] + [int(c) for c in cut[cut < len(m)]] + [len(m)]
        return [m[a:b] for a, b in zip(cut, cut[1:])]

    feeds = [ragged(m) for m in mels]
    StreamServer(voc_ms, max_streams=SERVER_ROWS, chunk=chunk, overlap=overlap).warmup()

    def serve(streams):
        """[(spec, pieces)] through one 8-row server -> (audio per stream, steps)."""
        server = StreamServer(voc_ms, max_streams=SERVER_ROWS, chunk=chunk, overlap=overlap)
        steps, step = [0], server.step

        def counted():
            steps[0] += 1
            return step()

        server.step = counted
        handles = [server.open(**spec) for spec, _ in streams]
        got = {h: [] for h in handles}
        for h, wav in server.run({h: iter(p) for h, (_, p) in zip(handles, streams)}):
            got[h].append(wav)
        return [np.concatenate(got[h]) for h in handles], steps

    result = {}

    def run_crowded():
        result["audio"], result["steps"] = serve(list(zip(specs, feeds)))
        return result["audio"]

    crowded = live_path(f"StreamServer {SERVER_ROWS} rows at {chunk}:{overlap}", run_crowded,
                        stages, lambda: result["steps"][0])
    alone = serve([(specs[0], feeds[0])])[0][0]
    others = [(dict(seed=SEED + 100 + i, sid=i, noise_scale=1.0), ragged(mels[(i + 1) % len(mels)][::-1]))
              for i in range(5)]
    moved = serve(others + [(specs[0], feeds[0])])[0][-1]  # the same stream in row 5
    log(f"live StreamServer: stream 0 among {len(specs) - 1} others, bit-identical alone "
        f"{np.array_equal(alone, crowded[0])}, in row {len(others)} among {len(others)} other "
        f"streams {np.array_equal(moved, crowded[0])}")
    if not (np.array_equal(alone, crowded[0]) and np.array_equal(moved, crowded[0])):
        raise RuntimeError("StreamServer: a stream's audio depends on its row or co-tenants")
    worst = 0.0
    for i, (spec, pieces, got) in enumerate(zip(specs, feeds, crowded)):
        want = np.concatenate(list(voc_ms.stream_mel_to_wav(
            iter(pieces), chunk=chunk, overlap=overlap, seed=spec["seed"],
            sid=np.array([spec["sid"]]), noise_scale=spec["noise_scale"])))
        if got.shape != want.shape or not np.isfinite(got).all():
            raise RuntimeError(f"StreamServer stream {i}: {got.shape} vs B = 1 {want.shape}")
        l1 = mel_l1([got], [want])
        worst = max(worst, l1)
        log(f"  stream {i} ({len(mels[i])} frames, sid {spec['sid']}, noise "
            f"{spec['noise_scale']}): batched vs B = 1 max |diff| "
            f"{np.abs(got - want).max():.3e}, mel-L1 {l1:.6f} (<= 1e-3)")
    if not worst <= 1e-3:
        raise RuntimeError(f"StreamServer: batched vs B = 1 mel-L1 {worst} above 1e-3")

    # the programs: graph against eager, a replay's trace, times, captures
    live_programs(vocoder_hifi2, vocoder_wn0, voc_ms, card, rng)

    # voice conversion, f32, B = 2 x 400 frames of the chunked decode's spectrogram
    net = build_synthesizer(hps_ms, device=dev)
    net.load_state_dict(state_ms, strict=True)
    net.eval()
    y = torch.from_numpy(chunked[: 2 * 400 * HOP].reshape(2, -1)).to(dev)
    spec = spectrogram(y, vocoder_hifi2.mel_cfg)
    lens = torch.tensor([400, 333], device=dev)
    eps_q = torch.randn((2, spec.shape[1], inter), generator=torch.Generator().manual_seed(SEED))
    with torch.inference_mode():
        src = torch.tensor([5, 77], device=dev)
        o_same, _, (z, _, z_hat) = net.voice_conversion(spec, lens, eps_q.to(dev), src, src)
        o_other, _, _ = net.voice_conversion(spec, lens, eps_q.to(dev), src,
                                             torch.tensor([12, 3], device=dev))
    rel = ((z_hat - z).abs().max() / z.abs().max()).item()
    moved = (o_other - o_same).abs().max().item()
    log(f"live voice conversion, iitp_base_ms f32, spec {tuple(spec.shape)}: same speaker "
        f"|z_hat - z| max {rel:.2e} of max |z| (<= 1e-4); another speaker max |diff| {moved:.3e}")
    for o in (o_same, o_other):
        if o.shape != (2, 400 * HOP, 1) or not torch.isfinite(o).all() or o.abs().max() > 1:
            raise RuntimeError(f"voice conversion: bad waveform {tuple(o.shape)}")
    if not (rel <= 1e-4 and moved > 1e-3):
        raise RuntimeError("voice conversion: z not recovered, or the target speaker does nothing")
    del net, voc_ms

    # timing: the warm-up table, operating points and stream sweep, in a fresh
    # process so that the first window is really cold
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "smart_vocoder_torch.tools.bench_streaming"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log("  " + line)
    if proc.returncode != 0:
        raise RuntimeError(f"bench_streaming failed:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    bench = json.loads(lines[-1])
    numbers = [v for rows in ("warmup", "points", "streams") for r in bench[rows]
               for v in r.values()]
    if not all(np.isfinite(v) for v in numbers) or {r["chunk"] for r in bench["warmup"]} < {
            1024, 384} or [r["streams"] for r in bench["streams"]] != [1, 8, 32]:
        raise RuntimeError(f"bench_streaming: {bench}")
    log(f"live timing (tools/bench_streaming.py, fresh process): {time.time() - t0:.1f} s  "
        f"[{card}]")


TRAIN_FRAMES = 1000       # the bucket of the train-step phase (B = train.batch_size)
# bf16 against f32 on the same weights and noise, set from the readings: on an
# H100 the five losses of this phase's first step differed by 2.0e-5 (loss/d)
# to 7.1e-4 (loss/g/kl), so 3e-3 is ~4x the worst sound reading and leaves
# little room for a bf16-only rounding fault.
BF16_LOSS_REL = 3e-3


def mrf_conv_ms(averages, rows: int, stage_shapes) -> tuple:
    """Device ms of the decoder's MRF convolutions, (forward, backward), from
    a profile grouped by input shape: the ``aten::convolution`` and
    ``aten::convolution_backward`` calls on an input ``(rows, C, T)`` of a
    stage and a ``(C, C, k)`` weight (no other conv of the step has both)."""
    fwd = bwd = 0.0
    for e in averages:
        if e.key == "aten::convolution":
            x, w = e.input_shapes[0], e.input_shapes[1]
        elif e.key == "aten::convolution_backward":
            x, w = e.input_shapes[1], e.input_shapes[2]
        else:
            continue
        if (len(x) == 3 and len(w) == 3 and tuple(x) in stage_shapes
                and w[0] == w[1] == x[1]):
            if e.key == "aten::convolution":
                fwd += e.device_time_total / 1e3
            else:
                bwd += e.device_time_total / 1e3
    return fwd, bwd


def train_step_phase(card: str, dev, hps, hps_ms, rows: int = 16,
                     frames: int = TRAIN_FRAMES) -> dict:
    """Phase 10: the GAN train step at full width on the card (module graph on
    cuDNN autograd; no hand-written kernel is on this path, as none is on
    JAX's step). Raises on any failure."""
    import copy
    import itertools

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from smart_vocoder_torch.kernels import LAUNCHES, reset_launch_counts
    from smart_vocoder_torch.tools import bench_train
    from smart_vocoder_torch.training import init_train_state, make_train_step

    def params(state):
        return itertools.chain(state.net_g.named_parameters(prefix="g"),
                               state.net_d.named_parameters(prefix="d"))

    def finite(metrics, label):
        bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
        if bad:
            raise RuntimeError(f"train step {label}: non-finite metrics {bad}")

    hps_b, hps_f = bench_train.leg_hps(hps, "bf16"), bench_train.leg_hps(hps, "f32")
    seg = hps.train.segment_size // hps.data.hop_length
    batch = bench_train.synthetic_batch(hps, rows, frames, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    draws = {"eps_q": torch.randn((rows, frames, hps.model.inter_channels), generator=gen,
                                  device=dev),
             "ids_slice": (torch.rand((rows,), generator=gen, device=dev)
                           * (frames - seg + 1)).int(),
             "perm": torch.tensor([2, 0, 3, 1], device=dev)}
    log(f"train step: iitp_base B={rows} x {frames} frames, segment {hps.train.segment_size} "
        f"samples, seeded G and D  [{card}]")

    # f32 and bf16 from the same weights and noise; no kernel of the port launches
    s16 = init_train_state(hps_b, seed=SEED, device=dev)
    s32 = init_train_state(hps_f, device=dev, net_g=copy.deepcopy(s16.net_g),
                           net_d=copy.deepcopy(s16.net_d))
    start = {k: p.detach().clone() for k, p in params(s16)}
    step16, step32 = make_train_step(hps_b, dev), make_train_step(hps_f, dev)
    reset_launch_counts()
    s32, m32 = step32(s32, batch, **draws)
    s16, m16 = step16(s16, batch, **draws)
    torch.cuda.synchronize()
    if any(LAUNCHES.values()):
        raise RuntimeError(f"train step: a hand-written kernel launched: {dict(LAUNCHES)}")
    finite(m32, "f32")
    finite(m16, "bf16")
    for k in bench_train.LOSSES:
        rel = abs(m16[k].item() - m32[k].item()) / abs(m32[k].item())
        log(f"  {k}: bf16 {m16[k].item():.6f} f32 {m32[k].item():.6f} rel {rel:.2e} "
            f"(<= {BF16_LOSS_REL:g}) -> {'ok' if rel <= BF16_LOSS_REL else 'FAIL'}")
        if rel > BF16_LOSS_REL:
            raise RuntimeError(f"train step: bf16 {k} off the f32 step by {rel:.2e}")
    log(f"  grad_norm_g bf16 {m16['grad_norm_g'].item():.4f} f32 {m32['grad_norm_g'].item():.4f}; "
        f"grad_norm_d bf16 {m16['grad_norm_d'].item():.4f} f32 {m32['grad_norm_d'].item():.4f}")
    del s32, step32

    # step 2: D after the step is D after its own update (the G phase moves none
    # of its parameters); after it every G and D parameter has moved
    after_d, d_step = {}, s16.opt_d.step

    def record_d(*args, **kwargs):
        out = d_step(*args, **kwargs)
        after_d.update({k: v.detach().clone() for k, v in s16.net_d.state_dict().items()})
        return out

    s16.opt_d.step = record_d
    s16, m = step16(s16, batch, **draws)
    s16.opt_d.step = d_step
    finite(m, "bf16 step 2")
    changed = [k for k, v in s16.net_d.state_dict().items() if not torch.equal(v, after_d[k])]
    if changed or any(p.grad is not None for p in s16.net_d.parameters()):
        raise RuntimeError(f"train step: the G phase changed D: {changed[:5]}")
    still = [k for k, p in params(s16) if torch.equal(p, start[k])]
    log(f"  D unchanged by the G phase; {len(start) - len(still)}/{len(start)} G and D "
        f"parameters moved in 2 steps")
    if still:
        raise RuntimeError(f"train step: parameters that did not move: {still[:5]}")

    # 10 steps on one batch, the same draws: the mel loss falls
    mels = []
    for _ in range(10):
        s16, m = step16(s16, batch, **draws)
        finite(m, "bf16 overfit")
        mels.append(m["loss/g/mel"].item())
    log(f"  10 steps on one batch: loss/g/mel {mels[0]:.4f} -> {mels[-1]:.4f} "
        f"({' '.join(f'{v:.3f}' for v in mels)})")
    if not mels[-1] < mels[0]:
        raise RuntimeError(f"train step: the mel loss did not fall: {mels}")

    # one step under the profiler: the top kernels, the MRF convolutions' share
    stages = {(rows, hps.model.upsample_initial_channel // 2 ** (i + 1),
               seg * int(np.prod(hps.model.upsample_rates[: i + 1])))
              for i in range(len(hps.model.upsample_rates))}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step16(s16, batch, **draws)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    busy = sum(e.self_device_time_total for e in averages
               if e.device_type == DeviceType.CUDA) / 1e3
    fwd, bwd = mrf_conv_ms(prof.key_averages(group_by_input_shape=True), rows, stages)
    log(f"profiled train step (bf16): device busy {busy:.1f} ms (its share of the "
        f"unprofiled step: bench_train below); decoder MRF convolutions {fwd:.2f} ms forward + "
        f"{bwd:.2f} ms backward = {100 * (fwd + bwd) / busy:.1f}% of the busy time "
        f"(stages {sorted(stages)})  [{card}]")
    if not fwd > 0 or not bwd > 0:
        raise RuntimeError("train step profile: no MRF convolution found")
    log("profile (train step bf16, top kernels by device time):")
    for line in averages.table(sort_by="self_device_time_total", row_limit=20).splitlines():
        log("  " + line)
    del s16, step16, start
    torch.cuda.empty_cache()

    # one conditioned step: iitp_base_ms, sid per row
    hps_ms = bench_train.leg_hps(hps_ms, "bf16")
    batch_ms = bench_train.synthetic_batch(hps_ms, rows, frames, dev)
    if batch_ms.sid is None:
        raise RuntimeError("iitp_base_ms: the batch has no speaker ids")
    s_ms = init_train_state(hps_ms, seed=SEED, device=dev)
    s_ms, m = make_train_step(hps_ms, dev)(s_ms, batch_ms, torch.Generator(device=dev)
                                           .manual_seed(SEED))
    finite(m, "iitp_base_ms")
    log(f"  conditioned step (iitp_base_ms, sids {batch_ms.sid[:4].tolist()}...): "
        f"loss/g/total {m['loss/g/total'].item():.4f}, loss/d/total "
        f"{m['loss/d/total'].item():.4f}")
    del s_ms, batch_ms
    torch.cuda.empty_cache()

    # timing: bf16 and f32 legs, 5 interleaved rounds (tools/bench_train.py)
    res = bench_train.main(device=dev, hps=hps, frames=frames, rounds=ROUNDS, iters=3,
                           legs=("bf16", "f32"))
    for leg, r in res["legs"].items():
        if not all(np.isfinite(r[k]) for k in ("step_ms", "busy_share", "peak_mem_gib")):
            raise RuntimeError(f"bench_train {leg}: {r}")
    return res


# phase 11: the training runtime (data, checkpoints, the loop, the CLI) on the card
RUNTIME_CLIPS = 96         # MIN_FRAMES-MAX_FRAMES: every iitp_base bucket from 300 to 1000
MIN_FRAMES, MAX_FRAMES = 345, 1000
RESUME_STEPS, RESUME_FROM = 40, 20
TIMING_STEPS = 30
PROFILE_START, PROFILE_STEPS = 10, 10
RESUME_LOSS_REL = 1e-4
STEADY_FROM = 5            # step statistics over steps STEADY_FROM .. the last


def loss_lines(log_path: str) -> dict:
    """{step: [loss_d, loss_g, fm, mel, kl]} from the loop's loss list lines
    (``tools/report_convergence.py:parse``; a line with a non-finite value
    does not parse, so its step is missing)."""
    from smart_vocoder_torch.tools.report_convergence import parse

    return {int(r[5]): r[:5] for r in parse(log_path)[0]}


def eval_lines(log_path: str) -> dict:
    """{step: eval/mel_l1} from the loop's eval lines (the same parser)."""
    from smart_vocoder_torch.tools.report_convergence import parse

    return dict(parse(log_path)[1])


def check_run_log(model_dir: str, steps, label: str) -> dict:
    """The run's loss lines cover ``steps`` and are finite; so is every
    scalar of the plain writer, where it wrote one. Returns the loss lines."""
    import math

    log_path = os.path.join(model_dir, "train.log")
    traj = loss_lines(log_path)
    if sorted(traj) != list(steps):
        raise RuntimeError(f"{label}: loss lines for steps {sorted(traj)}, expected {list(steps)}")
    if not all(math.isfinite(v) for losses in traj.values() for v in losses):
        raise RuntimeError(f"{label}: a non-finite loss: {traj}")
    jsonl = os.path.join(model_dir, "scalars.jsonl")
    if os.path.exists(jsonl):
        with open(jsonl) as f:
            bad = [ln for ln in f if not math.isfinite(json.loads(ln)["value"])]
        if bad:
            raise RuntimeError(f"{label}: non-finite scalars: {bad[:3]}")
    return traj


def run_train_cli(work: str, cfg_path: str, model: str, max_steps: int, extra_env=None,
                  timeout: int = 600) -> tuple:
    """``python -m smart_vocoder_torch.train`` in a subprocess from ``work``;
    returns (model_dir, wall seconds, stdout). Raises if it fails."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    env.update(extra_env or {})
    cmd = [sys.executable, "-m", "smart_vocoder_torch.train", "-c", cfg_path, "-m", model,
           "--max-steps", str(max_steps)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"train CLI ({model}): exit {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return os.path.join(work, "logs", model), time.perf_counter() - t0, proc.stdout


class LoopProbe:
    """Timers around one in-process run of ``training.loop.run``: how long
    each ``next()`` on the train loader blocks and when it returns, the host
    time of each item and collation, each eval and each save (with its
    bytes), and the audio each step consumes. Installed by subclassing the
    loop's loader, dataset and checkpoint manager and wrapping
    ``pad_to_bucket`` and ``_evaluate``; ``close`` puts them back."""

    def __init__(self, dev, hop: int, sr: int):
        from smart_vocoder_torch.data import pipeline
        from smart_vocoder_torch.training import loop as loop_lib
        from smart_vocoder_torch.training.step import Batch

        self.dev, self.hop, self.sr = dev, hop, sr
        self.waits, self.got, self.audio_s, self.items, self.pads = [], [], [], [], []
        self.pins, self.copies, self.evals, self.saves, self.save_bytes = [], [], [], [], []
        self._saved = [(loop_lib, n, getattr(loop_lib, n)) for n in
                       ("BucketedLoader", "AudioSpecDataset", "CheckpointManager", "_evaluate")]
        self._saved += [(Batch, "to", Batch.to), (Batch, "pin_memory", Batch.pin_memory)]
        self._saved.append((pipeline, "pad_to_bucket", pipeline.pad_to_bucket))
        probe = self
        to, pin_memory = Batch.to, Batch.pin_memory

        def timed_to(batch, device, non_blocking=False):
            t0 = time.perf_counter()
            out = to(batch, device, non_blocking)
            if non_blocking:  # the loader's copy of a pinned batch
                probe.copies.append(time.perf_counter() - t0)
            return out

        def timed_pin(batch):
            t0 = time.perf_counter()
            out = pin_memory(batch)
            probe.pins.append(time.perf_counter() - t0)
            return out

        Batch.to, Batch.pin_memory = timed_to, timed_pin

        class Loader(loop_lib.BucketedLoader):
            def iter_from(self, skip=0):
                it = super().iter_from(skip)
                if not self.sampler.shuffle:  # the eval loader
                    return it
                return probe._timed(it, list(iter(self.sampler))[skip:], self.sampler.lengths)

        class Dataset(loop_lib.AudioSpecDataset):
            def __getitem__(self, index):
                t0 = time.perf_counter()
                out = super().__getitem__(index)
                probe.items.append(time.perf_counter() - t0)
                return out

        class Manager(loop_lib.CheckpointManager):
            def save(self, step, state, epoch, learning_rate, **kwargs):
                probe.sync()
                t0 = time.perf_counter()
                super().save(step, state, epoch, learning_rate, **kwargs)
                probe.saves.append(time.perf_counter() - t0)
                probe.save_bytes.append(sum(os.path.getsize(self.path(t, step)) for t in "GD"))

        def pad(*args, **kwargs):
            t0 = time.perf_counter()
            out = probe._saved[-1][2](*args, **kwargs)
            probe.pads.append(time.perf_counter() - t0)
            return out

        evaluate = loop_lib._evaluate

        def timed_evaluate(*args, **kwargs):
            probe.sync()
            t0 = time.perf_counter()
            evaluate(*args, **kwargs)
            probe.sync()
            probe.evals.append(time.perf_counter() - t0)

        loop_lib.BucketedLoader, loop_lib.AudioSpecDataset = Loader, Dataset
        loop_lib.CheckpointManager, loop_lib._evaluate = Manager, timed_evaluate
        pipeline.pad_to_bucket = pad

    def sync(self):
        import torch

        torch.cuda.synchronize(self.dev)

    def _timed(self, it, batches, lengths):
        try:
            for idxs in batches:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                t1 = time.perf_counter()
                self.waits.append(t1 - t0)
                self.got.append(t1)
                self.audio_s.append(sum(lengths[i] for i in idxs) * self.hop / self.sr)
                yield batch
        finally:
            it.close()

    def close(self):
        for mod, name, value in self._saved:
            setattr(mod, name, value)


def steady_steps(probe: LoopProbe, eval_steps) -> list:
    """Indices of the steps, from STEADY_FROM to the second to last, whose
    interval (this step's batch in hand to the next's) holds no eval or save."""
    return [i for i in range(STEADY_FROM, len(probe.got) - 1) if i not in eval_steps]


def trace_busy(trace_path: str) -> tuple:
    """(busy ms, window ms) of a Chrome trace: the union of the card's kernel,
    copy and set intervals, and the span of every event in it."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    gpu = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -1e30
    for a, b in gpu:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    return busy / 1e3, window / 1e3


def isolated_step_ms(hps, dev, frames: int, iters: int = 10) -> float:
    """Host ms a bf16 step on one synthetic ``frames`` batch takes, with
    cuDNN's algorithm search off, as in the loop (mean of ``iters`` after 2)."""
    import torch

    from smart_vocoder_torch.tools import bench_train
    from smart_vocoder_torch.training import init_train_state, make_train_step

    state = init_train_state(hps, seed=SEED, device=dev)
    step = make_train_step(hps, dev)
    batch = bench_train.synthetic_batch(hps, hps.train.batch_size, frames, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for _ in range(2):
        state, _ = step(state, batch, gen)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, batch, gen)
    m["loss/g/total"].item()
    return (time.perf_counter() - t0) / iters * 1e3


def training_runtime_phase(card: str, dev, base_cfg: dict, ms_cfg: dict,
                           isolated_ms: float) -> dict:
    """Phase 11: the training runtime on the card, through the ``train``
    entry point and ``training.loop.run``. Raises on any failure."""
    import copy
    import math
    import shutil
    import statistics
    import tempfile

    import torch

    from smart_vocoder_torch.config import HParams, validate
    from smart_vocoder_torch.models import build_synthesizer
    from smart_vocoder_torch.tools.make_corpus import write_corpus
    from smart_vocoder_torch.training import init_train_state
    from smart_vocoder_torch.training import loop as loop_lib
    from smart_vocoder_torch.utils.checkpoint import CheckpointManager
    from smart_vocoder_torch.utils.torch_compat import (
        load_reference_generator,
        load_torch_checkpoint,
    )

    work = tempfile.mkdtemp(prefix="svt_runtime_")
    walls, t_mark = {}, [time.perf_counter()]

    def mark(part):  # wall seconds since the previous mark
        now = time.perf_counter()
        walls[part], t_mark[0] = now - t_mark[0], now
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False  # as in the CLI's process (the loop leaves it off)
    try:
        t0 = time.perf_counter()
        files = write_corpus(os.path.join(work, "corpus"), RUNTIME_CLIPS, MIN_FRAMES, MAX_FRAMES)
        files_ms = write_corpus(os.path.join(work, "corpus_ms"), 16, MIN_FRAMES, MAX_FRAMES,
                                speakers=int(ms_cfg["data"]["n_speakers"]), seed=SEED + 1)
        log(f"training runtime: {RUNTIME_CLIPS} clips of {MIN_FRAMES}-{MAX_FRAMES} frames "
            f"written in {time.perf_counter() - t0:.1f} s")

        def config(name, base, filelist, **train):
            cfg = copy.deepcopy(base)
            cfg["train"].update(eval_interval=20, fp16_run=True, **train)
            cfg["data"].update(training_files=filelist, validation_files=filelist)
            # one process on one card, whatever the machine (the CLI starts one
            # rank per card at the default -1; phase 12 runs that)
            cfg.setdefault("tpu", {}).update(bf16_run=True, keep_ckpts=2, data_parallel=1)
            path = os.path.join(work, f"{name}.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            return path, cfg

        def hps_of(cfg, name):
            hps = validate(HParams(**copy.deepcopy(cfg)))
            hps.model_dir = os.path.join(work, "logs", name)
            return hps

        mark("corpus")
        # ---- resume legs: A straight, B from A's step-RESUME_FROM pair -------------
        total, mid = RESUME_STEPS, RESUME_FROM
        cfg_path, cfg = config("resume", base_cfg, files, log_interval=1)
        dir_a, wall_a, _ = run_train_cli(work, cfg_path, "A", total)
        traj_a = check_run_log(dir_a, range(total), "run A")
        with open(os.path.join(dir_a, "train.log")) as f:
            first = f.readline().strip()
        log(f"  run A: {total} steps in {wall_a:.1f} s (process included); train.log's first "
            f"line: {first.split(chr(9))[-1]}")
        evals_a = eval_lines(os.path.join(dir_a, "train.log"))
        want_evals = list(range(0, total, 20))
        if sorted(evals_a) != want_evals or not all(map(math.isfinite, evals_a.values())):
            raise RuntimeError(f"run A: eval/mel_l1 at {evals_a}, expected steps {want_evals}")
        log(f"  run A eval/mel_l1: {evals_a}")
        mngr_a = CheckpointManager(dir_a)
        if mngr_a.steps() != [mid, total]:
            raise RuntimeError(f"run A kept pairs {mngr_a.steps()}, expected [{mid}, {total}]")

        # restore: the state read back equals, bit for bit, what A wrote
        hps_b16 = hps_of(cfg, "restore")
        state = init_train_state(hps_b16, seed=SEED + 7, device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, epoch, step = mngr_a.restore(state, step=mid)
        torch.cuda.synchronize(dev)
        restore_ms = (time.perf_counter() - t0) * 1e3
        payload = {t: load_torch_checkpoint(mngr_a.path(t, mid)) for t in "GD"}

        def same(a, b):
            if torch.is_tensor(a):
                return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
            if isinstance(a, dict):
                return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
            if isinstance(a, (list, tuple)):
                return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
            return a == b

        for tag, net, opt in (("G", state.net_g, state.opt_g), ("D", state.net_d, state.opt_d)):
            if not (same(net.state_dict(), payload[tag]["model"])
                    and same(opt.state_dict(), payload[tag]["optimizer"])):
                raise RuntimeError(f"restore of {tag}_{mid}.pth is not bit-equal to the file")
        if state.step != mid + 1:
            raise RuntimeError(f"restored step {state.step}, expected {mid + 1}")
        log(f"  restore of A's step-{mid} pair: G, D and both AdamW states bit-equal to the "
            f"files (step {state.step}, epoch {epoch}); restore {restore_ms:.0f} ms  [{card}]")
        del state
        torch.cuda.empty_cache()

        os.makedirs(os.path.join(work, "logs", "B"))
        for tag in "GD":
            shutil.copy(mngr_a.path(tag, mid), os.path.join(work, "logs", "B"))
        # run B also takes the all-reduce path: a 1-rank NCCL group from torchrun's variables
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        dist_env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        dir_b, wall_b, _ = run_train_cli(work, cfg_path, "B", total, extra_env=dist_env)
        traj_b = check_run_log(dir_b, range(mid + 1, total), "run B")
        with open(os.path.join(dir_b, "train.log")) as f:
            log_b = f.read()
        if f"resumed from step {mid + 1}" not in log_b:
            raise RuntimeError("run B did not resume from A's checkpoint")
        group = next((ln for ln in log_b.splitlines() if "data parallel:" in ln), "")
        if "torch.distributed nccl: rank 0 of 1" not in group:
            raise RuntimeError(f"run B: no NCCL group: {group!r}")
        names = ("loss/d/total", "loss/g/total", "loss/g/fm", "loss/g/mel", "loss/g/kl")
        first_rel = [abs(b - a) / abs(a) for a, b in zip(traj_a[mid + 1], traj_b[mid + 1])]
        per_step = [max(abs(b - a) / abs(a) for a, b in zip(traj_a[s], traj_b[s]))
                    for s in sorted(traj_b)]
        bit = traj_a[mid + 1] == traj_b[mid + 1]
        log(f"  run B ({group.split('data parallel: ')[-1].strip()}; resumed at step {mid + 1}, "
            f"{wall_b:.1f} s): first step's losses vs A's "
            + ", ".join(f"{n} rel {r:.1e}" for n, r in zip(names, first_rel))
            + f" -> {'bit-equal' if bit else 'not bit-equal'}; the worst of the five at steps "
            f"{mid + 1}-{total - 1}: " + " ".join(f"{r:.0e}" for r in per_step))
        if max(first_rel) > RESUME_LOSS_REL:
            raise RuntimeError(f"run B's first step is off run A's by {max(first_rel):.2e}")
        net = build_synthesizer(hps_b16)
        last = CheckpointManager(dir_b).latest_step()
        load_reference_generator(os.path.join(dir_b, f"G_{last}.pth"), net)
        log(f"  G_{last}.pth of run B loads strictly into a fresh SynthesizerTrn")

        mark("resume legs")
        # ---- timing legs, in this process ------------------------------------------
        def timed_leg(name, steps, **tpu):
            leg_path, leg_cfg = config(name, base_cfg, files, log_interval=5)
            leg_cfg["tpu"].update(tpu)
            hps = hps_of(leg_cfg, name)
            probe = LoopProbe(dev, hps.data.hop_length, hps.data.sampling_rate)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            try:
                loop_lib.run(hps, max_steps=steps, device=dev)
            finally:
                probe.close()
            probe.wall = time.perf_counter() - t0
            probe.peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
            probe.hps = hps
            return probe

        def report(label, probe, evals_at):
            idx = steady_steps(probe, evals_at)
            iv = [(probe.got[i + 1] - probe.got[i]) * 1e3 for i in idx]
            waits = [probe.waits[i] * 1e3 for i in range(STEADY_FROM, len(probe.waits))]
            per_item = statistics.median(probe.items) * 1e3
            rows = probe.hps.train.batch_size
            copies = [c * 1e3 for c in probe.copies[STEADY_FROM:]] or [float("nan")]
            pins = [c * 1e3 for c in probe.pins] or [float("nan")]
            rec = {
                "step_ms": statistics.median(iv), "step_ms_min": min(iv), "step_ms_max": max(iv),
                "step_ms_mean": statistics.fmean(iv), "steps": len(iv),
                "wait_ms": statistics.median(waits), "wait_ms_max": max(waits),
                "copy_ms": statistics.median(copies), "pin_ms": statistics.median(pins),
                "item_ms": per_item, "pad_ms": statistics.median(probe.pads) * 1e3,
                "batch_build_ms": per_item * rows + statistics.median(probe.pads) * 1e3,
                "eval_ms": [e * 1e3 for e in probe.evals],
                "save_ms": [s * 1e3 for s in probe.saves],
                "ckpt_mb": probe.save_bytes[-1] / 1e6, "peak_gib": probe.peak_gib,
                # every step from the first batch in hand to the last, evals and saves included
                "audio_x": sum(probe.audio_s[:-1]) / (probe.got[-1] - probe.got[0]),
                "audio_x_steady": sum(probe.audio_s[i] for i in idx) / (sum(iv) / 1e3),
            }
            log(f"  {label}: loop step median {rec['step_ms']:.1f} ms (range "
                f"{rec['step_ms_min']:.1f}-{rec['step_ms_max']:.1f}, mean "
                f"{rec['step_ms_mean']:.1f}, {rec['steps']} steps from {STEADY_FROM}, the "
                f"eval/save steps left out); loader wait median {rec['wait_ms']:.2f} ms, max "
                f"{rec['wait_ms_max']:.2f} (of it, the non-blocking copy's host call "
                f"{rec['copy_ms']:.2f}); host build {rec['item_ms']:.1f} ms an item, "
                f"{rec['pad_ms']:.1f} ms collation, {rec['pin_ms']:.1f} ms pinning, "
                f"{rec['batch_build_ms']:.0f} ms of host work a batch of {rows} (8 threads); eval "
                + "/".join(f"{e:.0f}" for e in rec["eval_ms"]) + " ms; save "
                + "/".join(f"{s:.0f}" for s in rec["save_ms"])
                + f" ms for {rec['ckpt_mb']:.0f} MB a pair; peak {rec['peak_gib']:.2f} GiB; "
                f"{rec['audio_x']:.1f} s of audio trained a wall second over steps 0-"
                f"{len(probe.got) - 2}, evals and saves included ({rec['audio_x_steady']:.1f} "
                f"over the steady steps alone)  [{card}]")
            return rec

        leg = timed_leg("timing", TIMING_STEPS)
        rec_plain = report("timing leg", leg, evals_at={0, 20})
        leg = timed_leg("timing_cached", TIMING_STEPS, cache_specs=True)
        rec_cached = report("timing leg, tpu.cache_specs on (epoch 1 writes the cache)", leg,
                            evals_at={0, 20})
        start, n = PROFILE_START, PROFILE_STEPS
        leg = timed_leg("profile", start + n, profile_steps=n, profile_start_step=start)
        trace = os.path.join(leg.hps.model_dir, "profile", f"trace_{start}_{start + n}.json")
        busy_ms, window_ms = trace_busy(trace)
        busy_step = busy_ms / n
        log(f"  profiled steps {start}-{start + n - 1} of the loop: card busy {busy_ms:.0f} of "
            f"{window_ms:.0f} ms ({100 * busy_ms / window_ms:.1f}%, the profiler's host cost "
            f"included); {busy_step:.1f} ms a step = {100 * busy_step / rec_plain['step_ms']:.1f}% "
            f"of the unprofiled loop step  [{card}]")
        iso_off = isolated_step_ms(hps_b16, dev, MAX_FRAMES)
        log(f"  isolated bf16 step at {MAX_FRAMES} frames: {iso_off:.1f} ms with cuDNN's "
            f"algorithm search off (as the loop), tools/bench_train.py {isolated_ms:.1f} ms with "
            f"it on (phase 10)  [{card}]")

        mark("timing, profile and isolated legs")
        # ---- a conditioned run: iitp_base_ms, path|sid filelists ---------------------
        ms_path, ms_cfg2 = config("ms", ms_cfg, files_ms, log_interval=1)
        hps_ms = hps_of(ms_cfg2, "ms")
        loop_lib.run(hps_ms, max_steps=5, device=dev)
        check_run_log(hps_ms.model_dir, range(5), "conditioned run")
        evals_ms = eval_lines(os.path.join(hps_ms.model_dir, "train.log"))
        if list(evals_ms) != [0]:
            raise RuntimeError(f"conditioned run: eval lines {evals_ms}")
        log(f"  conditioned run (iitp_base_ms, path|sid lists, 5 steps): losses finite, "
            f"eval/mel_l1 {evals_ms[0]:.4f}")

        mark("conditioned run")
        log("  phase 11 wall: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
            + f"; {sum(walls.values()):.1f} s in all")
        return {"plain": rec_plain, "cached": rec_cached, "busy_ms_step": busy_step,
                "restore_ms": restore_ms, "isolated_off_ms": iso_off,
                "first_rel": first_rel, "bit_equal": bit}
    finally:
        torch.backends.cudnn.benchmark = benchmark
        shutil.rmtree(work, ignore_errors=True)


# phase 12: the data axis -- a batch split over shards and cards, the CLI's ranks
DP_ROWS, DP_FRAMES = 32, 1000   # rows a card, frames a row: phase 5's B = 32 x 1000


def host_legs(legs: dict, rounds: int = ROUNDS) -> dict:
    """Each leg's host ms per call (a call that ends on the host, as
    ``mel_to_wav`` does): one warm-up call each, then ``rounds`` interleaved
    rounds (every other one in reverse order); {leg: (median, min, max)}."""
    import statistics

    for fn in legs.values():
        fn()
    times = {name: [] for name in legs}
    order = list(legs.items())
    for r in range(rounds):
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: (statistics.median(v), min(v), max(v)) for name, v in times.items()}


def data_parallel_phase(card: str, hps, state, vocoder_one, vocoder_f32, mel_l1) -> None:
    """Phase 12: ``Vocoder(devices=...)`` at iitp_base hifi 2 bf16 against
    the one-device ``vocoder_one`` on ``cuda:0`` (same weights), and the
    ``train`` CLI's ranks. Raises on any failure."""
    import pathlib
    import shutil
    import tempfile

    import torch

    from smart_vocoder_torch.inference import Vocoder
    from smart_vocoder_torch.kernels import mrf as K
    from smart_vocoder_torch.parallel import data_devices, split_rows
    from smart_vocoder_torch.tools import device_busy_ms
    from smart_vocoder_torch.utils.flops import synthesis_flops

    t_phase = time.perf_counter()
    search = torch.backends.cudnn.benchmark  # the script's setting, phase 5's
    rng = np.random.default_rng(SEED + 12)
    n_mels = hps.data.n_mel_channels
    opts = dict(dtype=torch.bfloat16, hifi=2, buckets=(DP_FRAMES,))

    def batch(b):
        return (rng.normal(0, 1, (b, DP_FRAMES, n_mels)) * 2.0 - 4.0).astype(np.float32)

    def shard_launches(voc, mel, shards):
        """``voc.mel_to_wav(mel, seed=SEED)`` with the counts reset just before:
        a hifi-2 call's stage kernels a shard, no FMA body."""
        K.reset_launch_counts()
        wavs = voc.mel_to_wav(mel, seed=SEED)
        torch.cuda.synchronize()
        got = {k: v for k, v in K.LAUNCHES.items() if v}
        if got != {k: v * shards for k, v in HIFI2_KERNELS.items()}:
            raise RuntimeError(f"{shards} shards launched {got}, expected a hifi-2 call's "
                               f"stage kernels a shard ({HIFI2_KERNELS})")
        if not all(w.shape == (DP_FRAMES * HOP,) and np.isfinite(w).all() for w in wavs):
            raise RuntimeError("a shard's audio is not finite or has the wrong length")
        return wavs, got

    def busy(fns, legs):
        """{leg: card-busy ms of one profiled call, summed over the cards}."""
        out = {k: device_busy_ms(fn, torch.device("cuda")) for k, fn in fns.items()}
        for k, ms in out.items():
            log(f"  {k}: the cards busy {ms:.1f} ms of one call "
                f"({100 * ms / legs[k][0]:.1f}% of its host median, summed over the cards)")
        return out

    def rate(legs, rows):
        """{leg: (x real time, TFLOP/s of the model count)} from host ms medians."""
        audio_s, flops = rows * DP_FRAMES * HOP / SR, synthesis_flops(hps, rows, DP_FRAMES)
        return {k: (audio_s / (ms / 1e3), flops / (ms / 1e3) / 1e12)
                for k, (ms, _, _) in legs.items()}

    # (a) two shards on one card, against the one-device decode of the same rows
    walls = {}
    t0 = time.perf_counter()
    b = DP_ROWS
    mel = batch(b)
    two = Vocoder(hps, state, devices=["cuda:0", "cuda:0"], **opts)
    walls["(a) init"] = time.perf_counter() - t0
    try:
        # the checks on cuDNN's heuristic plans: its timed search keeps its
        # choices per thread, and the shards run on threads of their own
        torch.backends.cudnn.benchmark = False
        got, launches = shard_launches(two, mel, 2)
        eps = two.batch_eps(SEED, b, DP_FRAMES).numpy()
        for r in split_rows(b, 2):
            want = vocoder_one.mel_to_wav(mel[r], eps=eps[r])
            if not all(np.array_equal(g, w) for g, w in zip(got[r], want)):
                raise RuntimeError(f"shard {r}: not bit-equal to the one-device decode of its "
                                   "rows on the same card")
        l1_whole = mel_l1(got, vocoder_one.mel_to_wav(mel, seed=SEED))
        l1_f32 = mel_l1(got, vocoder_f32.mel_to_wav(mel, seed=SEED))
        log(f"data parallel (a): 2 shards of {b // 2} rows on cuda:0, B = {b} x {DP_FRAMES}: "
            f"each shard bit-equal to the one-device decode of its rows; launches {launches}; "
            f"mel-L1 vs the one-device {b}-row decode {l1_whole:.3e} (bound 1e-3), vs the f32 "
            f"path {l1_f32:.5f} (bound 1e-2)")
        if not (l1_whole <= 1e-3 and l1_f32 <= 1e-2):
            raise RuntimeError("data parallel (a): the shards' audio is off the one-device "
                               "decode or the f32 path")
        walls["(a) checks"] = time.perf_counter() - t0 - walls["(a) init"]
        torch.backends.cudnn.benchmark = search
        fns = {"one device": lambda: vocoder_one.mel_to_wav(mel, seed=SEED),
               "two shards": lambda: two.mel_to_wav(mel, seed=SEED)}
        legs = host_legs(fns)
        rates = rate(legs, b)
        for k, (ms, lo, hi) in legs.items():
            log(f"  {k}: {ms:.1f} ms a mel_to_wav call ({lo:.1f}-{hi:.1f}, {ROUNDS} rounds), "
                f"{rates[k][0]:.1f}x real time, {rates[k][1]:.1f} TFLOP/s  [{card}]")
        busy(fns, legs)
    finally:
        torch.backends.cudnn.benchmark = search
        two.close()
    walls["(a) timing"] = time.perf_counter() - t0 - walls["(a) init"] - walls["(a) checks"]

    # (b) every card
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"data parallel (b) not run: {cards} CUDA card here; splitting over cards and the "
            "CLI's one rank per card need two or more (tests/test_torch_cuda.py has both)")
    else:
        t0 = time.perf_counter()
        devices = data_devices()
        b = DP_ROWS * cards
        mel = batch(b)
        many = Vocoder(hps, state, devices=devices, **opts)
        try:
            torch.backends.cudnn.benchmark = False  # the checks, as in (a)
            got, launches = shard_launches(many, mel, cards)
            eps = many.batch_eps(SEED, b, DP_FRAMES).numpy()
            for d, r in zip(devices, split_rows(b, cards)):
                want = vocoder_one.mel_to_wav(mel[r], eps=eps[r])
                l1 = mel_l1(got[r], want)
                diff = max(np.abs(g - w).max() for g, w in zip(got[r], want))
                log(f"data parallel (b): {d} rows {r.start}-{r.stop - 1} vs cuda:0's decode of "
                    f"them: mel-L1 {l1:.3e} (bound 1e-3), largest sample difference {diff:.3e}")
                if not l1 <= 1e-3:
                    raise RuntimeError(f"data parallel (b): {d}'s shard is off cuda:0's decode")
            torch.backends.cudnn.benchmark = search
            fns = {"one card": lambda: vocoder_one.mel_to_wav(mel[:DP_ROWS], seed=SEED),
                   f"{cards} cards": lambda: many.mel_to_wav(mel, seed=SEED)}
            legs = host_legs(fns)
            one_x = rate({"one card": legs["one card"]}, DP_ROWS)["one card"]
            all_x = rate({"all": legs[f"{cards} cards"]}, b)["all"]
            for k, (ms, lo, hi) in legs.items():
                log(f"  {k}: {ms:.1f} ms a call ({lo:.1f}-{hi:.1f}, {ROUNDS} rounds)  [{card}]")
            log(f"  aggregate {all_x[0]:.1f}x real time ({all_x[1] / cards:.1f} TFLOP/s a card) "
                f"against one card's {one_x[0]:.1f}x ({one_x[1]:.1f}): scaling "
                f"{all_x[0] / one_x[0]:.2f} of {cards}; launches {launches}")
            busy(fns, legs)
        finally:
            torch.backends.cudnn.benchmark = search
            many.close()
        walls["(b) serving"] = time.perf_counter() - t0

        # the train CLI at a tiny config, data_parallel -1, no torchrun
        t0 = time.perf_counter()
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from test_torch_distributed import write_run_config  # the tiny config of its CLI tests

        work = tempfile.mkdtemp(prefix="svt_dp_")
        try:
            write_run_config(pathlib.Path(work))
            model_dir, wall, _ = run_train_cli(work, "cfg.json", "dp", 3)
            with open(os.path.join(model_dir, "train.log")) as f:
                ranks = f"torch.distributed nccl: rank 0 of {cards} on cuda:0"
                if ranks not in f.read():
                    raise RuntimeError(f"the train CLI did not start one rank per card: "
                                       f"'{ranks}' is not in its log")
            traj = check_run_log(model_dir, range(3), "train CLI, one rank per card")
            log(f"data parallel (b): the train CLI at tpu.data_parallel -1 started {cards} "
                f"NCCL ranks, 3 steps in {wall:.1f} s, loss/g/total "
                f"{[round(traj[s][1], 3) for s in range(3)]}")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        walls["(b) train CLI"] = time.perf_counter() - t0
    log(f"  phase 12 wall {time.perf_counter() - t_phase:.1f} s: " +
        ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))


# phase 13: the model axis -- the optimizer state split over a model group of cards
MA_ROWS = 16   # phase 10's batch: rows x TRAIN_FRAMES frames, segment 8192
MA_RULE = {"G": (343, 639), "D": (48, 111)}  # JAX's rule at iitp_base, M = 2: (sharded, all)
MA_LOSS_REL = 1e-4  # step 1 of a split batch against one process on the whole, at least


def rel_diff(a, b) -> float:
    """The largest relative difference of two lists of losses."""
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def model_axis_phase(card: str, hps) -> None:
    """Phase 13: the train step over the mesh's model axis
    (``tools/bench_model_axis.py``), iitp_base bf16 at full width from the
    seeded init, phase 10's batch with the draws passed in. Raises on any
    failure."""
    import shutil
    import tempfile

    import torch

    from smart_vocoder_torch.models import build_discriminator, build_synthesizer
    from smart_vocoder_torch.parallel import dist as dist_lib
    from smart_vocoder_torch.parallel import leaf_sharded
    from smart_vocoder_torch.tools import bench_model_axis as bma
    from smart_vocoder_torch.tools.bench_train import LOSSES, leg_hps

    t_phase = time.perf_counter()
    hps = leg_hps(hps, "bf16")
    counts, elems = {}, {}
    for tag, net in (("G", build_synthesizer(hps)), ("D", build_discriminator(hps))):
        shapes = [p.shape for p in net.parameters()]
        counts[tag] = (sum(leaf_sharded(s, 2) for s in shapes), len(shapes))
        elems[tag] = [(int(np.prod(s)), leaf_sharded(s, 2)) for s in shapes]
    # both f32 AdamW moments of every tensor, of a 1/M block where the rule shards it
    moments_mb = {m: 8 * sum(n // m if sharded else n for e in elems.values() for n, sharded in e)
                  / 1e6 for m in (1, 2)}
    log(f"model axis: JAX's shard rule at iitp_base, M = 2, takes {counts['G'][0]} of G's "
        f"{counts['G'][1]} tensors and {counts['D'][0]} of D's {counts['D'][1]}; both AdamW "
        f"moments come to {moments_mb[1]:.1f} MB a card at M = 1 and {moments_mb[2]:.1f} at "
        "M = 2 (from the shapes)")
    if counts != MA_RULE:
        raise RuntimeError(f"model axis: the rule takes {counts}, expected {MA_RULE}")

    def report(label, ranks, m):
        """Print a leg's readings (rank 0's, with the spread over the ranks)
        and hold its optimizer state to the shapes' count."""
        legs = [r[label] for r in ranks]
        leg = legs[0]
        mb = [x["optimizer_mb"] for x in legs]
        if not all(abs(x - moments_mb[m]) <= 1e-3 * moments_mb[m] for x in mb):
            raise RuntimeError(f"model axis {label}: optimizer state {mb} MB, expected "
                               f"{moments_mb[m]:.1f} at M = {m}")
        if not all(np.isfinite(x["check_losses"]).all() for x in legs):
            raise RuntimeError(f"model axis {label}: non-finite losses")
        text = (f"  {label}: mesh {leg['mesh'].split(' (')[0]}, {leg['rows']} rows a card: "
                f"optimizer state {max(mb):.1f} MB a card")
        if "step_ms" in leg:
            if not all(np.isfinite(x["last_losses"]).all() for x in legs):
                raise RuntimeError(f"model axis {label}: non-finite losses while timed")
            busy = [x["busy_share"] for x in legs]
            text += (f"; peak {max(x['peak_mem_gib'] for x in legs):.2f} GiB; step "
                     f"{span((leg['step_ms'], leg['step_ms_min'], leg['step_ms_max']))} ms "
                     f"({leg['rounds']} rounds of {leg['iters']}, rank 0; the ranks' medians "
                     f"{min(x['step_ms'] for x in legs):.2f}-{max(x['step_ms'] for x in legs):.2f}"
                     f"); busy {100 * min(busy):.1f}-{100 * max(busy):.1f}% over the cards, "
                     f"NCCL's kernels apart ({max(x['nccl_ms'] for x in legs):.1f} ms a step "
                     "at most)")
        log(text + f"  [{card}]")
        return leg

    def spawn(n, legs, options=None):
        dist_lib.start_ranks(n, bma.rank_main, (work, hps, legs, "cuda", options))
        ranks = []
        for r in range(n):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f)["legs"])
            os.remove(os.path.join(work, f"rank{r}.json"))
        return ranks

    walls = {}
    work = tempfile.mkdtemp(prefix="svt_ma_")
    try:
        bma.write_inputs(work, hps, MA_ROWS, TRAIN_FRAMES)
        # (a) one process on cuda:0, twice: the card's run-to-run drift
        t0 = time.perf_counter()
        a = bma.run_legs(hps, work, [("one", 1, MA_ROWS, True), ("one again", 1, MA_ROWS, True)],
                         torch.device("cuda:0"))
        log(f"model axis (a): one process on cuda:0, B = {MA_ROWS} x {TRAIN_FRAMES}, twice "
            "from the same weights and draws (checks: cuDNN's search off; timing: on)")
        one = report("one", [a], 1)
        report("one again", [a], 1)
        drift = [rel_diff(x, y) for x, y in zip(a["one again"]["check_losses"],
                                                 one["check_losses"])]
        later = rel_diff(a["one again"]["last_losses"], one["last_losses"])
        log(f"  run-to-run drift of the five losses: steps 1-3 "
            f"{', '.join(f'{d:.2e}' for d in drift)}; step {one['steps']} {later:.2e}; "
            f"parameters after step 3 " + ("bit-equal" if a["one again"]["against"]["one"][0]
                                            else f"differ by up to "
                                            f"{a['one again']['against']['one'][1]:.3e}"))
        walls["(a)"] = time.perf_counter() - t0

        cards = torch.cuda.device_count()
        if cards < 2:
            log(f"model axis (b)-(d) not run: {cards} CUDA card here; NCCL puts one rank on "
                "a card, and a model group needs two (four for (c)-(d))")
            return
        # (b) D = 1 x M = 2 on cards 0-1, 8 rows a card, against (a)
        t0 = time.perf_counter()
        b = spawn(2, [("d1 x m2", 2, MA_ROWS // 2, True)])
        log(f"model axis (b): D = 1 x M = 2 on cuda:0-1, the same {MA_ROWS} rows split")
        two = report("d1 x m2", b, 2)
        tol = max(MA_LOSS_REL, drift[0])
        for k, x, y in zip(LOSSES, two["check_losses"][0], one["check_losses"][0]):
            rel = abs(x - y) / abs(y)
            log(f"  step 1 {k}: {x:.6f} against (a)'s {y:.6f}, rel {rel:.2e} (<= {tol:.1e}) "
                f"-> {'ok' if rel <= tol else 'FAIL'}")
            if rel > tol:
                raise RuntimeError(f"model axis (b): step 1's {k} off one process's by {rel:.2e}")
        walls["(b)"] = time.perf_counter() - t0
        if cards < 4:
            log(f"model axis (c)-(d) not run: {cards} CUDA cards here, they need four")
            return
        # (c) D = 2 x M = 2 against D = 4 x M = 1 on the same 4 rows a card; (d) D = 4 at
        # 16 rows a card (each card trains phase 10's whole batch)
        t0 = time.perf_counter()
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # cuBLAS repeats itself, in the ranks
        try:
            c = spawn(4, [("d4 x m1", 1, MA_ROWS // 4, True),
                          ("d2 x m2", 2, MA_ROWS // 4, True),
                          ("d4 x m1 again", 1, MA_ROWS // 4, False),
                          ("d4 x m1, 16 rows a card", 1, MA_ROWS, True)], {"deterministic": True})
        finally:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        log("model axis (c): D = 2 x M = 2 against D = 4 x M = 1 on cuda:0-3, the same "
            f"{MA_ROWS // 4} rows a card, 3 steps (the checks with cudnn.deterministic and "
            "torch.use_deterministic_algorithms on)")
        ref = report("d4 x m1", c, 1)
        report("d2 x m2", c, 2)
        for s, (x, y) in enumerate(zip(c[0]["d2 x m2"]["check_losses"], ref["check_losses"])):
            log(f"  step {s + 1}: the five losses {'equal' if x == y else 'differ'} "
                f"(rel {rel_diff(x, y):.2e})")
        def apart(leg, other):
            """Whether ``leg`` equals ``other`` on every card, and their largest difference."""
            got = [r[leg]["against"][other] for r in c]
            return all(eq for eq, _ in got), max(diff for _, diff in got)

        axis, again = apart("d2 x m2", "d4 x m1"), apart("d4 x m1 again", "d4 x m1")
        if axis[0]:
            log("  the parameters after 3 steps are bit-equal on every card")
        elif again[0]:
            raise RuntimeError(f"model axis (c): D = 2 x M = 2 differs from D = 4 x M = 1 by up "
                               f"to {axis[1]:.3e}, and D = 4 x M = 1 repeats itself bit for "
                               "bit: the model axis changed the result")
        else:
            warned = sorted({w for r in c for leg in r.values() for w in leg["nondeterministic"]})
            log(f"  the parameters after 3 steps differ by up to {axis[1]:.3e} (against the "
                f"repeat {apart('d2 x m2', 'd4 x m1 again')[1]:.3e}); cause: the step does not "
                f"repeat itself on the card, D = 4 x M = 1 against itself differs by up to "
                f"{again[1]:.3e}; ops without a deterministic implementation: {warned}")
        walls["(c)"] = time.perf_counter() - t0
        log("model axis (d): a full-width step at D = 4 x M = 1, each card training phase 10's "
            f"{MA_ROWS} rows ({4 * MA_ROWS} rows a step)")
        d4 = report("d4 x m1, 16 rows a card", c, 1)
        audio_s = 4 * MA_ROWS * TRAIN_FRAMES * HOP / SR
        log(f"  {audio_s / (d4['step_ms'] / 1e3):.1f}x real time over four cards against one "
            f"card's {audio_s / 4 / (one['step_ms'] / 1e3):.1f}x in (a): scaling "
            f"{4 * one['step_ms'] / d4['step_ms']:.2f} of 4  [{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        log(f"  phase 13 wall {time.perf_counter() - t_phase:.1f} s: " +
            ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))


# mel-L1 against the torch reference's waveform: the f32 path as
# tests/test_torch_cuda.py holds it (1.494e-6 on the H100), and the timed hifi-2
# path at about 1.5x its reading (0.00453); both well inside the reported
# fidelity_target of 1e-2, which TF32 or bf16 in the f32 path would still meet
REF_TOL = 1e-4
SERVING_HIFI_TOL = 7e-3
INPUTS_TOL = 1e-4  # the recipe's mel / noise against the fixture's (JAX's own: 6.4e-5, 3.3e-5)


def headline_phase(card: str, hps) -> dict:
    """14. ``python -m smart_vocoder_torch.bench --iters 10 --no-train`` in a
    fresh process (the search setting of this script does not reach it), on
    the fidelity recipe's weights, held to the golden fixture; the recipe's
    own inputs against the fixture's first. Returns the child's JSON line."""
    from smart_vocoder_torch.utils.golden import fidelity_inputs

    gz = np.load(os.path.join(ROOT, "tests", "fixtures", "golden_iitp_base.npz"))
    mel, _, eps = fidelity_inputs(hps)
    d_mel = float(np.abs(mel - gz["mel"]).max())
    d_eps = float(np.abs(eps - gz["eps"]).max())
    log(f"fidelity_inputs (numpy) against the fixture: mel {d_mel:.2e}, eps {d_eps:.2e} "
        f"(bound {INPUTS_TOL:g})")
    if not (d_mel <= INPUTS_TOL and d_eps <= INPUTS_TOL):
        raise RuntimeError("the recipe's inputs are not the fixture's")
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "smart_vocoder_torch.bench", "--iters", "10",
                           "--no-train"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    for line in proc.stderr.strip().splitlines():
        log("  bench: " + line)
    if proc.returncode != 0:
        raise RuntimeError(f"the headline entry point failed (exit {proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"headline (python -m smart_vocoder_torch.bench, {time.time() - t0:.1f} s): "
        f"{json.dumps(out)}")
    value = out.get("value", float("nan"))
    if not (out.get("mel_l1_vs_reference", np.inf) <= REF_TOL
            and out.get("mel_l1_serving_hifi", np.inf) <= SERVING_HIFI_TOL
            and out.get("fidelity_target") == 1e-2
            and "rtf_fast_bf16" in out and np.isfinite(value) and value > 0
            and out.get("hifi") == 2 and out.get("device") == card):
        raise RuntimeError(f"the headline entry point: {out}")
    return out


# phase 15: the training-evidence tools -- a speaker-conditioned corpus, 200 steps, samples
MS_STEPS = 200
# bounds on the last loss line (step 180) of the 200-step run, from the card's runs
# (this run: mel 21.59, KL 1.353; the 200-clip conditioned run of
# tools/convergence_runs.py: 24.38, 1.137), with room for the card's run-to-run
# drift; JAX's speaker-conditioned run read mel 26.79, KL 1.05 at step 200
# (CONVERGENCE.md)
MS_MEL_BOUND = 32.0
MS_KL_BOUND = 3.0
MS_CLIPS, MS_SIDS = 2, (0, 2)  # validation clips x speakers of the sample set


def convergence_tools_phase(card: str, dev) -> dict:
    """15. The short form of the port's convergence runs, through its tools:
    ``tools/make_synth_data.py --ms`` (64 clips, 4 speakers), ``python -m
    smart_vocoder_torch.train`` on its config for ``MS_STEPS`` steps in a
    subprocess (``tpu.data_parallel: 1``), the log read by
    ``tools/report_convergence.py``'s parser (a finite row every
    ``log_interval`` steps; mel and KL of the last row under their bounds),
    then ``tools/make_ms_samples.py`` on the last ``G_*.pth`` for
    ``MS_CLIPS`` validation clips x ``MS_SIDS``: one launch each of
    ``up_mrf_stage`` and ``mrf_stage`` a call and no other kernel, finite
    mel-L1, and the two speakers' audio different. Raises on any failure."""
    import math
    import shutil
    import tempfile

    from smart_vocoder_torch.kernels import LAUNCHES, reset_launch_counts
    from smart_vocoder_torch.tools import make_ms_samples, make_synth_data, report_convergence

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="svt_convergence_")
    try:
        cfg_path = make_synth_data.make_synth_data(os.path.join(work, "data"), ms=True)
        with open(cfg_path) as f:
            cfg = json.load(f)
        cfg["tpu"]["data_parallel"] = 1  # one process on one card, whatever the machine
        with open(cfg_path, "w") as f:
            json.dump(cfg, f, indent=2)
        model_dir, wall, _ = run_train_cli(work, cfg_path, "ms", MS_STEPS)
        rows, evals = report_convergence.parse(os.path.join(model_dir, "train.log"))
        every = cfg["train"]["log_interval"]
        report = os.path.join(work, "report.md")
        report_convergence.write_report(rows, evals, report, every=40)
        with open(report) as f:
            for line in f.read().strip().splitlines():
                log("  " + line)
        if [r[5] for r in rows] != list(range(0, MS_STEPS, every)):
            raise RuntimeError(f"convergence run: loss rows at {[r[5] for r in rows]}, expected "
                               f"every {every} steps (a non-finite row does not parse)")
        if not all(math.isfinite(v) for r in rows for v in r) or [s for s, _ in evals] != [0]:
            raise RuntimeError(f"convergence run: rows {rows}, evals {evals}")
        mel, kl = rows[-1][3], rows[-1][4]
        log(f"  convergence run ({MS_STEPS} steps through the CLI, {wall:.1f} s with the "
            f"process): step {rows[-1][5]} mel {mel:.3f} (bound {MS_MEL_BOUND}; JAX at 200: "
            f"26.79), KL {kl:.3f} (bound {MS_KL_BOUND}; JAX at 200: 1.05)  [{card}]")
        if not (mel < MS_MEL_BOUND and kl < MS_KL_BOUND):
            raise RuntimeError(f"convergence run: mel {mel}, KL {kl} over their bounds")

        with open(cfg["data"]["validation_files"]) as f:
            clips = [ln.split("|")[0] for ln in f.read().split()][:MS_CLIPS]
        if make_ms_samples.generator_path(model_dir) != os.path.join(model_dir,
                                                                    f"G_{MS_STEPS}.pth"):
            raise RuntimeError(f"convergence run: no G_{MS_STEPS}.pth in {model_dir}")
        voc = make_ms_samples.load_vocoder(cfg_path, model_dir, dev)
        out_dir = os.path.join(work, "samples")
        os.makedirs(out_dir)
        for clip in clips:
            wavs = []
            for sid in MS_SIDS:
                reset_launch_counts()
                rec = make_ms_samples.sample(voc, clip, sid, out_dir)
                launches = {k: v for k, v in LAUNCHES.items() if v}
                if launches != HIFI2_KERNELS:
                    raise RuntimeError(f"samples: launches a call {launches}")
                if not math.isfinite(rec["mel_l1"]):
                    raise RuntimeError(f"samples: mel-L1 {rec['mel_l1']}")
                wavs.append(rec["wav"])
            if np.array_equal(wavs[0], wavs[1]):
                raise RuntimeError(f"samples: sids {MS_SIDS} give the same audio for {clip}")
        log(f"  samples of G_{MS_STEPS}.pth: {len(clips)} clips x sids {MS_SIDS}, a hifi-2 "
            f"call's stage kernels a call, the speakers' audio different  [{card}]")
        log(f"  phase 15 wall {time.perf_counter() - t_phase:.1f} s")
        return {"mel": mel, "kl": kl, "train_wall_s": wall}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# phase 16: BigVGAN-v2's route -- the fused anti-aliased SnakeBeta, one call at the cell's shapes
BIGVGAN_CONFIG = os.path.join("vocbench", "configs", "bigvgan_v2_22khz_80band_256x.json")
BIGVGAN_TRAFFIC = os.path.join("vocbench", "traffic", "batch_bigvgan.json")
BIGVGAN_LAUNCHES = 109  # aa_snake launches a call: 18 a stage (six stages) and the tail
PEAK_F32 = 67e12        # FLOP/s, f32 FMA outside the tensor cores (H100 SXM data sheet)
AA_FLOPS = 24 + 24 + 2 * 5  # per input element: up filter, down filter, SnakeBeta twice


def aa_record(x, out) -> dict:
    """The activation's bound: its f32 arithmetic (``AA_FLOPS`` an input
    element, as ``vocbench/flops_bigvgan.py`` counts it) over the f32 peak
    against one read of ``x`` and one write of ``out`` over the memory rate."""
    flops = float(AA_FLOPS * x.numel())
    t_ops = flops / PEAK_F32 * 1e3
    t_bytes = (x.numel() * x.element_size() + out.numel() * out.element_size()) / HBM_RATE * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "flops": flops,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def bigvgan_phase(card: str, dev) -> dict:
    """16. BigVGAN-v2 at its published widths, weights from the benchmark's
    seeded rule (``vocbench/weights.py`` over ``vocbench/reference/bigvgan.py``'s
    leaves): (a) ``aa_snake`` against ``aa_snake_plain`` (torch's chain in f32,
    TF32 off) at every stage shape of a B = 32 call on the 1024 bucket,
    (32, 768, 4096) ... (32, 24, 262144), reading f32 (the residual stream) and
    bf16 (a conv's output): within one bf16 rounding of the plain result (with
    slack near zero of 2e-5 of the largest value), each timed beside the plain
    chain; (b) one ``Vocoder.mel_to_wav`` at the cell's shapes (B = 32, 345-1000
    frames, the 1024 bucket), the launch counts reset just before it: exactly
    109 ``aa_snake`` launches and no other hand-written kernel, its mel-L1
    against the plain reference under the cell's limit. Returns the kernel's
    record, timed at the stage-1 shape on f32 input; ``library_ms`` is the
    plain chain's time there."""
    import torch

    from smart_vocoder_torch.config import HParams, validate
    from smart_vocoder_torch.inference import Vocoder
    from smart_vocoder_torch.kernels import LAUNCHES, amp, reset_launch_counts
    from smart_vocoder_torch.models.bigvgan import kaiser_sinc_filter
    from vocbench import compare, weights
    from vocbench.reference import bigvgan as ref

    with open(os.path.join(ROOT, BIGVGAN_CONFIG)) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, BIGVGAN_TRAFFIC)) as f:
        traffic = json.load(f)
    hps = validate(HParams(**{k: cfg[k] for k in ("data", "model", "tpu")}))
    m = cfg["model"]
    rows, bucket = int(traffic["batch"]), 1024
    rng = np.random.default_rng(SEED)
    taps = kaiser_sinc_filter().to(dev)

    log(f"aa_snake vs torch's chain at BigVGAN-v2's stage shapes  [{card}]")
    records = {}
    t = bucket
    for i, u in enumerate(m["upsample_rates"]):
        t *= u
        c = m["upsample_initial_channel"] // 2 ** (i + 1)
        la = torch.from_numpy(rng.uniform(-0.5, 0.5, c).astype(np.float32)).to(dev)
        lb = torch.from_numpy(rng.uniform(-0.5, 0.5, c).astype(np.float32)).to(dev)
        act = amp.Snake(*amp.snake_coefficients(la, lb))
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((rows, c, t), device=dev) * 3).to(dtype)
            with compare.reference_precision():
                want = amp.aa_snake_plain(x, act, taps)
            got = amp.aa_snake(x, act, taps)
            tol = want.abs() * 2.0 ** -8 + 2e-5 * want.abs().max()
            diff = (got.float() - want).abs()
            if not torch.isfinite(got).all() or not bool((diff <= tol).all()):
                raise RuntimeError(f"aa_snake {tuple(x.shape)} {dtype}: outside one bf16 "
                                   f"rounding of the plain chain (max {diff.max().item():.3e})")
            err = diff.max().item()
            del want, diff, tol
            rec = {**kernel_times(lambda: amp.aa_snake(x, act, taps),
                                  lambda: amp.aa_snake_plain(x, act, taps), 20),
                   **aa_record(x, got), "max_abs_err": err}
            rec["library_ms"] = rec["plain_ms"]
            log(f"  aa_snake {tuple(x.shape)} {str(dtype)[6:]}: {rec['ms']:.4f} ms "
                f"({rec['ms_min']:.4f}-{rec['ms_max']:.4f}), {card_span(rec)}, torch's chain "
                f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
                f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of it  [{card}]")
            records[(c, dtype)] = rec
            del x, got
    torch.cuda.empty_cache()

    sizes = ref.Sizes.from_config(cfg)
    bound_log = float(cfg["seeded_weights"]["log_scale_bound"])
    state = weights.make(ref.generator_params(sizes, bound_log), SEED, dev)
    voc = Vocoder(hps, state, device=dev)
    lo, hi = traffic["frames"]
    lengths = rng.integers(lo, hi + 1, rows)
    lengths[0] = hi
    mel = rng.standard_normal((rows, hi, sizes.n_mels)).astype(np.float32) * 2 - 4
    mel[np.arange(hi)[None] >= lengths[:, None]] = 0
    voc.mel_to_wav(mel, lengths)  # warm-up: cuDNN's search, the library's load
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = voc.mel_to_wav(mel, lengths)
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in LAUNCHES.items() if v}
    if launched != {"aa_snake": BIGVGAN_LAUNCHES}:
        raise RuntimeError(f"BigVGAN call: launches {launched}, expected "
                           f"{{'aa_snake': {BIGVGAN_LAUNCHES}}}")
    voc.close()
    del voc
    torch.cuda.empty_cache()
    with compare.reference_precision():
        want = ref.batch_call(state, sizes, mel, lengths, dev)
    gaps = compare.waveform_gaps(got, want, cfg["data"])
    limit = float(traffic["limits"]["mel_l1"])
    log(f"BigVGAN mel_to_wav B = {rows}, bucket {bucket}: launches {launched}, wall "
        f"{1e3 * wall:.1f} ms ({float(lengths.sum()) * HOP / SR / wall:.1f}x real time), "
        f"mel-L1 vs the plain reference {gaps['mel_l1']:.5f} (limit {limit}), wav rel-L2 "
        f"{gaps['wav_rel_l2']:.5f}  [{card}]")
    if not gaps["mel_l1"] < limit:
        raise RuntimeError(f"BigVGAN call: mel-L1 {gaps['mel_l1']} over the cell's {limit}")
    first = m["upsample_initial_channel"] // 2
    return {"launches": launched["aa_snake"], **records[(first, torch.float32)]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    t_start = time.time()
    sys.path.insert(0, ROOT)
    from smart_vocoder_torch.config import load_config
    from smart_vocoder_torch.inference import Vocoder, set_precision_flags
    from smart_vocoder_torch.kernels import mrf as K
    from smart_vocoder_torch.kernels.gate import fused_gate, fused_gate_plain
    from smart_vocoder_torch.kernels.mrf_train import (
        branch_replay_plain,
        mrf_branch_bwd,
        mrf_branch_bwd_plain,
    )
    from smart_vocoder_torch.kernels._build import build
    from smart_vocoder_torch.kernels.decoder import _stage_branches, decoder_apply, pack_decoder
    from smart_vocoder_torch.kernels.wn_stack import (
        pack_wn_stack,
        wn_chunk,
        wn_chunk_plain,
        wn_layers_from_state_dict,
        wn_stack,
        wn_stack_plain,
    )
    from smart_vocoder_torch.models import build_synthesizer
    from smart_vocoder_torch.nn.wn import gated_activation
    from smart_vocoder_torch.ops import MelConfig, mel_spectrogram
    from smart_vocoder_torch.tools import ab_mrf_train, exp_mrf_variants
    from smart_vocoder_torch.utils.init import init_synthesizer

    # 1. device
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device {name}")
    set_precision_flags()
    torch.backends.cudnn.benchmark = True
    dev = torch.device("cuda")

    log(f"-- phase 2 starts at {time.time() - t_start:.0f} s")
    # 2. build
    t0 = time.time()
    so = build()
    log(f"build: {time.time() - t0:.1f} s -> {os.path.relpath(so, ROOT)}")
    # every bf16 instantiation of the tensor-core kernels runs its convs on the
    # tensor cores: wgmma from 64 channels (the WN stack's 192 too), mma.sync at
    # 32; the backward's weight-gradient GEMM on mma.sync at every channel count
    sass = sass_mma_counts(str(so))
    for kernel, ops in sorted(sass.items()):
        log(f"  sass {kernel}: {ops}")
        params = kernel.split("<")[1].rstrip(">").split(", ")
        # <[Cin,] C, mode> for the stages, <C[, replay]> for the pair kernels, the
        # weight-gradient GEMM and the WN stack
        c = int(params[-2] if kernel.startswith(("mrf_stage", "up_mrf")) else params[0])
        wgmma = c >= 64 and not kernel.startswith("mrf_dw_mma")
        if ops["HGMMA" if wgmma else "HMMA"] == 0 or ops["HMMA" if wgmma else "HGMMA"] != 0:
            raise RuntimeError(f"{kernel}: not the MMA its channel count takes: {ops}")
    if len(sass) != 29:
        raise RuntimeError("expected the 6 + 4 instantiations of the stage kernels, 4 + 4 + 2 "
                           "of the unpacked stage's pair (stage, replay, F32_STORAGE), 1 of the "
                           "WN stack, 4 of the backward's dx step and 4 of its weight "
                           f"gradients: {sass}")

    hps = load_config(os.path.join(ROOT, "configs", "iitp_base.json"))
    net = init_synthesizer(build_synthesizer(hps, weight_norm=True), SEED)
    state = {k: v.detach() for k, v in net.state_dict().items()}
    del net
    vocoder_hifi2 = Vocoder(hps, state, dtype=torch.bfloat16, hifi=2, buckets=(1000,),
                            device=dev)
    dec = vocoder_hifi2.dec_params
    ks = tuple(hps.model.resblock_kernel_sizes)
    dil = tuple(hps.model.resblock_dilation_sizes[0])

    log(f"-- phase 3 starts at {time.time() - t_start:.0f} s")
    # 3. kernels against their plain versions at the main-path shapes
    rng = np.random.default_rng(SEED)
    records = {}

    def stage_branches(stage, dtype):
        return [tuple(a.to(dtype).float() for a in br)
                for br in _stage_branches(dec, stage, len(ks), len(dil), torch.float32)]

    log("kernels vs plain:")
    for t in (128000, 12345):
        x = torch.from_numpy(rng.normal(0, 0.5, (2 if t == 128000 else 1, t, 64))
                             .astype(np.float32)).to(dev)
        xb = x.bfloat16()
        br = stage_branches(2, torch.bfloat16)
        packed = K.pack_mrf_stage(br, dev)
        exact = K.mrf_stage_plain(xb, br, ks, dil, K.F32)
        for mode, kw in ((K.F32_STORAGE, {"f32_storage": True}), (K.BF16, {}),
                         (K.F32, {"x2": True})):
            tag = f"mrf_stage {tuple(x.shape)} {next(iter(kw), 'bf16')}"
            got = K.mrf_stage(xb, br, ks, dil, **kw)
            if not torch.equal(got, K.mrf_stage(xb, br, ks, dil, packed=packed, **kw)):
                raise RuntimeError(f"{tag}: weights packed once give other bits")
            want = K.mrf_stage_plain(xb, br, ks, dil, mode)
            err = compare(tag, got, want, exact, mode == K.F32)
            rec = records.setdefault("mrf_stage", {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if t == 128000 and mode == K.F32_STORAGE:
                rec.update(kernel_times(
                    lambda: K.mrf_stage(xb, br, ks, dil, packed=packed, **kw),
                    lambda: K.mrf_stage_plain(xb, br, ks, dil, mode), 3))
                rec.update(bound(mrf_flops(*x.shape, ks, len(dil)), [xb, got, *sum(br, ())]))
                log(f"  mrf_stage {tuple(x.shape)} f32_storage: kernel {rec['ms']:.3f} ms "
                    f"({rec['ms_min']:.3f}-{rec['ms_max']:.3f}, {card_span(rec)}), "
                    f"plain {rec['plain_ms']:.2f} ms, bound {rec['bound_ms']:.3f} ms  [{card}]")
            elif t == 128000:
                ms = time_legs({"k": lambda: K.mrf_stage(xb, br, ks, dil, packed=packed, **kw)},
                               3)["k"]
                log(f"  {tag}: kernel {span(ms)} ms  [{card}]")
        # true-f32 activations and weights: the f32 FMA route, with and without
        # the edge mask (the kernels that stage 3 and its variants ran before)
        br32 = stage_branches(2, torch.float32)
        for kname, kw in (("mrf_stage", {}), ("mrf_stage_variant", {"mask_edges": False})):
            before = K.LAUNCHES[kname + "_fma"]
            got = K.mrf_stage(x, br32, ks, dil, **kw)
            if K.LAUNCHES[kname + "_fma"] != before + 1:
                raise RuntimeError(f"{kname}: f32 inputs did not take the FMA kernel")
            want = K.mrf_stage_plain(x, br32, ks, dil, K.F32, **kw)
            tag = f"{kname} {tuple(x.shape)} f32 (FMA route)"
            rec = records.setdefault(kname, {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], compare(tag, got, want, want, True))
            if t == 128000:
                ms = time_legs({"k": lambda: K.mrf_stage(x, br32, ks, dil, **kw)}, 1)["k"]
                rec["earlier_ms"] = ms[0]
                log(f"  {tag}: kernel {span(ms)} ms  [{card}]")
        del br32
        # the options of the packed-MRF variants, each against its plain version
        for label, mode, kw in (("nomask", K.BF16, {"mask_edges": False}),
                                ("f32acc", K.F32_STORAGE, {"f32_storage": True,
                                                           "out_dtype": torch.bfloat16}),
                                ("all_f32", K.F32_STORAGE, {"mask_edges": False,
                                                            "f32_storage": True,
                                                            "out_dtype": torch.bfloat16})):
            mask_edges = kw.get("mask_edges", True)
            got = K.mrf_stage(xb, br, ks, dil, packed=packed, **kw)
            want = K.mrf_stage_plain(xb, br, ks, dil, mode, mask_edges, True)
            exact_v = K.mrf_stage_plain(xb, br, ks, dil, K.F32, mask_edges)
            if got.dtype != torch.bfloat16:
                raise RuntimeError(f"mrf_stage {label}: output {got.dtype}")
            err = compare(f"mrf_stage {tuple(x.shape)} {label}", got, want, exact_v, False,
                          ulp_slack=True)
            rec = records.setdefault("mrf_stage_variant", {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if t == 128000 and label == "nomask":
                rec.update(kernel_times(
                    lambda: K.mrf_stage(xb, br, ks, dil, packed=packed, **kw),
                    lambda: K.mrf_stage_plain(xb, br, ks, dil, mode, mask_edges, True), 3))
                rec.update(bound(mrf_flops(*x.shape, ks, len(dil)), [xb, got, *sum(br, ())]))
                log(f"  mrf_stage {tuple(x.shape)} nomask: kernel {rec['ms']:.3f} ms "
                    f"({rec['ms_min']:.3f}-{rec['ms_max']:.3f}), plain {rec['plain_ms']:.2f} "
                    f"ms, bound {rec['bound_ms']:.3f} ms  [{card}]")
        del exact_v
        u = x  # stage 4 input: (B, Tu, 64) -> (B, 2*Tu, 1)
        up_w, up_b = dec["ups.3.weight"], dec["ups.3.bias"]
        post = dec["conv_post.weight"]
        for mode, hifi in ((K.F32, True), (K.BF16, False)):
            wdt = torch.bfloat16
            brr = stage_branches(3, wdt)
            uu = u if hifi else u.bfloat16()
            args = (up_w.to(wdt).float(), up_b.to(wdt).float(), 2, 1, brr, ks, dil)
            pw = post.to(wdt).float()
            up_packed = K.pack_up_mrf_stage(args[0], args[1], 2, 1, brr, pw, dev)
            tag = f"up_mrf_stage {tuple(uu.shape)} {'hifi' if hifi else 'bf16'}"
            got = K.up_mrf_stage(uu, args[0], args[1], 4, 2, 1, brr, ks, dil,
                                 post_weight=pw, hifi=hifi)
            if not torch.equal(got, K.up_mrf_stage(uu, args[0], args[1], 4, 2, 1, brr, ks, dil,
                                                   post_weight=pw, hifi=hifi, packed=up_packed)):
                raise RuntimeError(f"{tag}: weights packed once give other bits")
            want = K.up_mrf_stage_plain(uu, *args, mode, pw)
            exact = K.up_mrf_stage_plain(uu, *args, K.F32, pw)
            err = compare(tag, got, want, exact, mode == K.F32)
            rec = records.setdefault("up_mrf_stage", {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if t == 128000 and hifi:
                rec.update(kernel_times(lambda: K.up_mrf_stage(
                    uu, args[0], args[1], 4, 2, 1, brr, ks, dil, post_weight=pw, hifi=True,
                    packed=up_packed), lambda: K.up_mrf_stage_plain(uu, *args, mode, pw), 3))
                # hifi: f32 activations as hi + lo bf16 pairs, so two tensor-core passes
                b_, tu_, cin_ = uu.shape
                flops = 2 * (mrf_flops(b_, 2 * tu_, 32, ks, len(dil))
                             + 2.0 * 4 * cin_ * 32 * tu_ * b_ + 2.0 * 7 * 32 * 2 * tu_ * b_)
                rec.update(bound(flops, [uu, got, args[0], pw, *sum(brr, ())]))
                log(f"  up_mrf_stage {tuple(uu.shape)} hifi+post: kernel {rec['ms']:.3f} ms "
                    f"({rec['ms_min']:.3f}-{rec['ms_max']:.3f}), plain {rec['plain_ms']:.2f} ms, "
                    f"bound {rec['bound_ms']:.3f} ms  [{card}]")
            elif t == 128000:
                ms = time_legs({"k": lambda: K.up_mrf_stage(
                    uu, args[0], args[1], 4, 2, 1, brr, ks, dil, post_weight=pw,
                    packed=up_packed)}, 3)["k"]
                log(f"  {tag}+post: kernel {span(ms)} ms  [{card}]")
        # true-f32 u and weights, no hifi: the f32 FMA route (the kernel that
        # stage 4 ran before)
        brr = stage_branches(3, torch.float32)
        args = (up_w.float(), up_b.float(), 2, 1, brr, ks, dil)
        before = K.LAUNCHES["up_mrf_stage_fma"]
        got = K.up_mrf_stage(u, args[0], args[1], 4, 2, 1, brr, ks, dil, post_weight=post.float())
        if K.LAUNCHES["up_mrf_stage_fma"] != before + 1:
            raise RuntimeError("up_mrf_stage: f32 inputs did not take the FMA kernel")
        want = K.up_mrf_stage_plain(u, *args, K.F32, post.float())
        tag = f"up_mrf_stage {tuple(u.shape)} f32 (FMA route)"
        rec = records["up_mrf_stage"]
        rec["max_abs_err"] = max(rec["max_abs_err"], compare(tag, got, want, want, True))
        if t == 128000:
            ms = time_legs({"k": lambda: K.up_mrf_stage(
                u, args[0], args[1], 4, 2, 1, brr, ks, dil, post_weight=post.float())}, 1)["k"]
            rec["earlier_ms"] = ms[0]
            log(f"  {tag}: kernel {span(ms)} ms  [{card}]")
        del x, xb, u, exact

    def record(name, err):
        rec = records.setdefault(name, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        return rec

    # the unpacked MRF stage (stages 2 and 1 under pallas_stage2) and the
    # stage-3 fold-up without the tail (128 -> 64)
    for stage, shape in ((1, (2, 64000, 128)), (0, (1, 8192, 256)), (1, (1, 12345, 128))):
        x = torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            if dt == torch.float32 and shape[1] != 12345:
                continue  # f32 is not on the serving path: the ragged case holds it
            xd, br = x.to(dt), stage_branches(stage, dt)
            mode = K.BF16 if dt == torch.bfloat16 else K.F32
            tag = f"mrf_stage_unpacked {shape} {'bf16' if mode == K.BF16 else 'f32'}"
            name_k = "mrf_stage_unpacked" if mode == K.BF16 else "mrf_stage_unpacked_fma"
            before = K.LAUNCHES[name_k]
            got = K.mrf_stage_unpacked(xd, br, ks, dil)
            if K.LAUNCHES[name_k] != before + len(ks) * len(dil):
                raise RuntimeError(f"{tag}: did not take {name_k}")
            packed = K.pack_mrf_stage(br, dev) if mode == K.BF16 else None
            if packed is not None and not torch.equal(
                    got, K.mrf_stage_unpacked(xd, br, ks, dil, packed=packed)):
                raise RuntimeError(f"{tag}: weights packed once give other bits")
            want = K.mrf_stage_plain(xd, br, ks, dil, mode)
            exact = K.mrf_stage_plain(xd, br, ks, dil, K.F32)
            rec = record("mrf_stage_unpacked", compare(tag, got, want, exact, mode == K.F32,
                                                       ulp_slack=True))
            if shape[1] != 12345:
                # the kernel with the weights packed once (as pack_decoder does),
                # its plain version, and the f32 FMA route it replaces, same shape
                x32, br32 = x.float(), stage_branches(stage, torch.float32)
                times = kernel_times(
                    lambda: K.mrf_stage_unpacked(xd, br, ks, dil, packed=packed),
                    lambda: K.mrf_stage_plain(xd, br, ks, dil, mode), 2,
                    earlier=lambda: K.mrf_stage_unpacked(x32, br32, ks, dil))
                ms = times["ms"]
                bnd = bound(mrf_flops(*shape, ks, len(dil)), [xd, got, *sum(br, ())])
                log(f"  {tag}: kernel {ms:.3f} ms ({times['ms_min']:.3f}-{times['ms_max']:.3f}, "
                    f"{card_span(times)}; {bnd['flops'] / ms / 1e9:.1f} TFLOP/s), plain "
                    f"{times['plain_ms']:.2f} ms, bound {bnd['bound_ms']:.3f} ms, f32 FMA route "
                    f"{times['earlier_ms']:.2f} ms  [{card}]")
                if not ms < times["plain_ms"]:
                    raise RuntimeError(f"{tag}: the kernel is not faster than its plain version")
                if shape == (2, 64000, 128):
                    rec.update(**times, **bnd)
                del x32, br32
        del x, xd, got, want, exact
    # the unpacked stage's F32_STORAGE mode (stages 1-2 at hifi >= 2)
    # its own generator, so the checks after it see the inputs they always saw
    f32s = unpacked_f32s_kernels(card, dev, stage_branches, ks, dil,
                                 np.random.default_rng(SEED + 19))
    records["mrf_stage_unpacked_f32s"] = {
        **f32s[str((32, 65536, 128))],
        "max_abs_err": max(r["max_abs_err"] for r in f32s.values())}
    up_w, up_b = dec["ups.2.weight"], dec["ups.2.bias"]
    for tu in (64000, 4321):
        u = torch.from_numpy(rng.normal(0, 0.5, (2, tu, 128)).astype(np.float32)).to(dev)
        ub, brr = u.bfloat16(), stage_branches(2, torch.bfloat16)
        args = (up_w.bfloat16().float(), up_b.bfloat16().float(), 2, 1, brr, ks, dil)
        tag = f"up_mrf_stage {tuple(ub.shape)} 128->64 bf16"
        got = K.up_mrf_stage(ub, args[0], args[1], 4, 2, 1, brr, ks, dil)
        up_packed = K.pack_up_mrf_stage(args[0], args[1], 2, 1, brr, None, dev)
        want = K.up_mrf_stage_plain(ub, *args, K.BF16)
        exact = K.up_mrf_stage_plain(ub, *args, K.F32)
        record("up_mrf_stage", compare(tag, got, want, exact, False))
        if tu == 64000:
            times = kernel_times(lambda: K.up_mrf_stage(ub, args[0], args[1], 4, 2, 1, brr, ks,
                                                        dil, packed=up_packed),
                                 lambda: K.up_mrf_stage_plain(ub, *args, K.BF16), 2)
            ms, plain = times["ms"], times["plain_ms"]
            bnd = bound(mrf_flops(2, 2 * tu, 64, ks, len(dil)) + 2.0 * 4 * 128 * 64 * tu * 2,
                        [ub, got, args[0], *sum(brr, ())])
            log(f"  {tag}: kernel {ms:.3f} ms ({times['ms_min']:.3f}-{times['ms_max']:.3f}), "
                f"plain {plain:.2f} ms, bound {bnd['bound_ms']:.3f} ms  [{card}]")
        del u, ub, got, want, exact

    # the WN stack: the 16 prior layers of the seeded weights. In bf16 a
    # summation-order flip cascades down the residual chain from launch to
    # launch, so each launch (one chunk of 4 layers) is held to the plain
    # version on the plain version's own state and running skip sum; f32 is
    # held over the whole stack.
    hidden = hps.model.hidden_channels
    lpc = 4
    enc_layers = wn_layers_from_state_dict(vocoder_hifi2.params, "enc_p.encoder",
                                           hps.model.get("enc_layers", 16))
    chunks = [enc_layers[s:s + lpc] for s in range(0, len(enc_layers), lpc)]
    for b, t, length in ((32, 1000, 1000), (3, 778, 501)):
        mask = (torch.arange(t, device=dev)[None, :] <
                torch.tensor([t] * (b - 1) + [length], device=dev)[:, None]).float()[..., None]
        x = torch.from_numpy(rng.normal(0, 1, (b, t, hidden)).astype(np.float32)).to(dev) * mask
        xb = x.bfloat16()
        packed = pack_wn_stack(enc_layers, hidden, torch.bfloat16, lpc, dev)
        carry, skip = xb, torch.zeros_like(xb)
        before = K.LAUNCHES["wn_stack"]
        for n, chunk in enumerate(chunks):
            final = n == len(chunks) - 1
            got = wn_chunk(carry, mask, chunk, hidden, skip, final, packed[n])
            if K.LAUNCHES["wn_stack"] != before + n + 1:
                raise RuntimeError("wn_chunk: bf16 inputs did not take the tensor-core kernel")
            if not all(torch.equal(a, b_) for a, b_ in
                       zip(got, wn_chunk(carry, mask, chunk, hidden, skip, final))):
                raise RuntimeError("wn_chunk: weights packed once give other bits")
            before += 1
            want = wn_chunk_plain(carry, mask, chunk, hidden, skip, final)
            exact = wn_chunk_plain(carry.float(), mask,
                                   [tuple(a.bfloat16().float() for a in lay) for lay in chunk],
                                   hidden, skip.float(), final)
            tag = f"wn_stack {tuple(x.shape)} bf16 launch {n + 1}/{len(chunks)}"
            for part, g, w, e in zip(("state", "skip sum"), got, want, exact):
                record("wn_stack", compare(f"{tag} {part}", g, w, e, False, ulp_slack=True))
            carry, skip = want
        before = K.LAUNCHES["wn_stack_fma"]
        got = wn_stack(x, mask, enc_layers, hidden, lpc)
        if K.LAUNCHES["wn_stack_fma"] != before + len(chunks):
            raise RuntimeError("wn_stack: f32 inputs did not take the FMA kernel")
        want = wn_stack_plain(x, mask, enc_layers, hidden, lpc)
        record("wn_stack", compare(f"wn_stack {tuple(x.shape)} x{len(enc_layers)} layers f32",
                                   got, want, want, True))
        if b == 32:
            pk32 = pack_wn_stack(enc_layers, hidden, torch.float32, lpc, dev)
            times = kernel_times(lambda: wn_stack(xb, mask, enc_layers, hidden, lpc, packed),
                                 lambda: wn_stack_plain(xb, mask, enc_layers, hidden, lpc), 3,
                                 earlier=lambda: wn_stack(x, mask, enc_layers, hidden, lpc, pk32))
            log(f"  wn_stack {tuple(x.shape)} x{len(enc_layers)} layers bf16: kernel "
                f"{times['ms']:.3f} ms ({times['ms_min']:.3f}-{times['ms_max']:.3f}, "
                f"{card_span(times)}), plain {times['plain_ms']:.2f} ms, f32 FMA route "
                f"{times['earlier_ms']:.3f} ms  [{card}]")
            if not times["ms"] < times["plain_ms"]:
                raise RuntimeError("wn_stack bf16: the kernel is not faster than its plain version")
            n_l = len(enc_layers)  # k=5 conv H -> 2H, then 1x1 to 2H (H in the last)
            flops = 2.0 * b * t * hidden * hidden * (12 * n_l - 1)
            records["wn_stack"].update(**times,
                                       **bound(flops, [xb, mask, xb, *sum(enc_layers, ())]))
        del x, xb, carry, skip, got, want, exact

    # the Triton gate: f32 within 1e-6 (exp and the divisions round differently
    # from torch's tanh and sigmoid); bf16 equal but for one ulp of the output
    def check_gate(x, g):
        got, want = fused_gate(x, g), fused_gate_plain(x, g)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != x.dtype or not torch.isfinite(got).all():
            raise RuntimeError(f"fused_gate {tuple(x.shape)}: bad output")
        diff = (got.float() - want.float()).abs()
        tol = (torch.full_like(diff, 1e-6) if x.dtype == torch.float32
               else want.float().abs().clamp_min(2.0 ** -126) * 2.0 ** -7)
        err = diff.max().item()
        ok = bool((diff <= tol).all())
        gs = "none" if g is None else tuple(g.shape)
        log(f"  fused_gate {tuple(x.shape)} g {gs} {str(x.dtype)[6:]}: max {err:.3e} "
            f"({'<= 1e-6' if x.dtype == torch.float32 else 'within one bf16 ulp'}) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("fused_gate disagrees with its plain version")
        return record("fused_gate", err), got

    for shape, gshape in (((32, 1000, 384), (32, 1, 384)), ((32, 1000, 384), None),
                          ((3, 777, 130), (3, 777, 130)), ((5, 62), (62,))):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.from_numpy(rng.normal(0, 2, shape).astype(np.float32)).to(dev, dt)
            g = (None if gshape is None else
                 torch.from_numpy(rng.normal(0, 1, gshape).astype(np.float32)).to(dev, dt))
            rec, got = check_gate(x, g)
            if shape == (32, 1000, 384) and dt == torch.bfloat16:
                # the events' time of 20 back-to-back launches includes what the host
                # spends launching them; the profiler's card time does not
                times = kernel_times(lambda: fused_gate(x, g), lambda: fused_gate_plain(x, g), 20)
                bnd = bound(12.0 * got.numel(), [x, got] if g is None else [x, g, got])
                events = span((times["ms"], times["ms_min"], times["ms_max"]))
                log(f"  fused_gate {shape} g {gshape} bf16: kernel {events} ms, "
                    f"{card_span(times)} ms, "
                    f"plain {times['plain_ms']:.4f} ms, bound {bnd['bound_ms']:.4f} ms  [{card}]")
                if g is not None:
                    rec.update(**times, **bnd)

    # the MRF branch backward at the training shapes (B = 16 segments of 32
    # frames) and a ragged length. The replay (x_j, h_j) is held to the plain
    # replay, then dx and the four weight gradients to the plain backward on
    # the kernel's own replay, so both take the same arm of the leaky
    # derivative everywhere. f32: replay within 1e-4 and gradients within 1e-3
    # of their largest entry. bf16: through `compare`, with the f32 plain
    # version on the same bf16 values (and the same replay) as `exact`.
    # A bf16 x runs the tensor-core kernels alone (a replay and a dx step per
    # residual pair and one weight-gradient launch per branch), an f32 x the
    # FMA body alone (two per pair); at the four training shapes the first must
    # beat the second, timed in turns.
    parts = ("dx", "dw1", "db1", "dw2", "db2")
    for stage, shape in ((0, (16, 256, 256)), (1, (16, 2048, 128)), (2, (16, 4096, 64)),
                         (3, (16, 8192, 32)), (2, (2, 1237, 64))):
        x = torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            xd, gd, br = x.to(dt), g.to(dt), stage_branches(stage, dt)
            for branch, k in zip(br, ks):
                tag = f"mrf_branch_bwd {shape} k={k} {str(dt)[6:]}"
                before = dict(K.LAUNCHES)
                dx, dws, replay = mrf_branch_bwd(xd, gd, branch, k, dil, with_replay=True)
                torch.cuda.synchronize()
                went = {n: c - before[n] for n, c in K.LAUNCHES.items() if c != before[n]}
                if went != ({"mrf_branch_bwd": 2 * len(dil) + 1} if dt == torch.bfloat16
                            else {"mrf_branch_bwd_fma": 2 * len(dil)}):
                    raise RuntimeError(f"{tag}: launched {went}")
                wdx, wdws = mrf_branch_bwd_plain(xd, gd, branch, k, dil, replay)
                got = list(zip(parts, (dx, *dws), (wdx, *wdws)))
                want_replay = branch_replay_plain(xd, branch, k, dil)
                steps = [(f"{n}_{j}", a, w) for n, vs, ws in zip("xh", replay, want_replay)
                         for j, (a, w) in enumerate(zip(vs, ws)) if n == "h" or j > 0]
                if dt == torch.float32:
                    for part, a, w in steps:
                        compare_f32(f"{tag} replay {part}", a, w, 1e-4)
                    for part, a, w in got:
                        record("mrf_branch_bwd", compare_f32(f"{tag} {part}", a, w, 1e-3))
                else:
                    exact_replay = branch_replay_plain(xd.float(), branch, k, dil)
                    exact = [e for n, es in zip("xh", exact_replay)
                             for j, e in enumerate(es) if n == "h" or j > 0]
                    for (part, a, w), e in zip(steps, exact):
                        compare(f"{tag} replay {part}", a, w, e, False, ulp_slack=True)
                    edx, edws = mrf_branch_bwd_plain(xd.float(), gd.float(), branch, k, dil,
                                                     [[v.float() for v in vs] for vs in replay])
                    for (part, a, w), e in zip(got, (edx, *edws)):
                        record("mrf_branch_bwd",
                               compare(f"{tag} {part}", a, w, e, False, ulp_slack=True))
        if shape[0] == 16:
            # the three branches in bf16 against the FMA route on the f32 inputs;
            # at the record's shape the plain version too
            br32 = stage_branches(stage, torch.float32)

            def run(xx, gg, bb, fn=mrf_branch_bwd):
                return lambda: [fn(xx, gg, b_, k, dil) for b_, k in zip(bb, ks)]

            kern, fma = run(xd, gd, br), run(x, g, br32)
            if shape == (16, 2048, 128):
                times = kernel_times(kern, run(xd, gd, br, mrf_branch_bwd_plain), 1, earlier=fma,
                                     profile=True)
            else:
                legs = time_legs({"kernel": kern, "earlier": fma}, 1)
                times = {"ms": legs["kernel"][0], "ms_min": legs["kernel"][1],
                         "ms_max": legs["kernel"][2], "earlier_ms": legs["earlier"][0]}
                times["card_ms"], times["card_ms_min"], times["card_ms_max"] = card_ms(kern)
            # per branch: 5 replayed convs, 6 dx convs, 6 dw products
            bnd = bound(17 / 6 * mrf_flops(*shape, ks, len(dil)),
                        [xd, gd] * len(ks) + [xd] * len(ks) + [a for b_ in br for a in b_] * 2)
            log(f"  mrf_branch_bwd {shape} bf16, the three branches: kernel {times['ms']:.3f} ms "
                f"({times['ms_min']:.3f}-{times['ms_max']:.3f}, {card_span(times)}; "
                f"{bnd['flops'] / times['ms'] / 1e9:.1f} TFLOP/s), f32 FMA route "
                f"{times['earlier_ms']:.2f} ms, plain {times.get('plain_ms')}, bound "
                f"{bnd['bound_ms']:.3f} ms  [{card}]")
            if not times["ms"] < times["earlier_ms"]:
                raise RuntimeError(f"mrf_branch_bwd {shape}: not faster than the FMA route")
            # the card time by kernel: replay, dx step, weight gradients, torch's own ops
            profile_step(f"mrf_branch_bwd {shape} bf16", kern, card, 10)
            if shape == (16, 2048, 128):
                records["mrf_branch_bwd"].update(**times, **bnd)
            del br32
        del x, g, xd, gd, dx, dws, wdx, wdws, replay, want_replay, steps, got

    log(f"-- phase 4 starts at {time.time() - t_start:.0f} s")
    # 4. the slice at full width
    n_mels, inter = hps.data.n_mel_channels, hps.model.inter_channels
    mel = (rng.normal(0, 1, (8, 1000, n_mels)) * 2.0 - 4.0).astype(np.float32)
    eps = rng.normal(0, 1, (8, 1000, inter)).astype(np.float32)
    short_mel, short_eps = mel[:1, :317], eps[:1, :317]
    mel_cfg = MelConfig.from_hparams(hps)
    vocoder_hifi0 = Vocoder(hps, state, dtype=torch.bfloat16, hifi=0, buckets=(1000,),
                            device=dev)
    vocoder_f32 = Vocoder(hps, state, dtype=torch.float32, use_kernels=False,
                          buckets=(1000,), device=dev)
    if not (vocoder_hifi2.use_kernels and vocoder_hifi2.hifi == 2 and vocoder_hifi0.use_kernels):
        raise RuntimeError("the serving path is not routed to the kernels")

    def requests(synth):
        """The batch and the short request through ``synth(mel, eps)``."""
        return synth(mel, eps) + synth(short_mel, short_eps)

    def vocoder(voc):
        return lambda m, e: voc.mel_to_wav(m, eps=e)

    stage2_packed = pack_decoder(vocoder_hifi0.dec_params, vocoder_hifi0.dec_cfg,
                                 torch.bfloat16, 0, pallas_stage2=True)

    def stage2_step(mel_t, lens_t, eps_t):
        """The pallas_stage2 route as scripts/exp_stage2_e2e.py drives it:
        the hifi-0 path's prior latent, then decoder_apply(pallas_stage2=True)
        with the weights packed once, as ``Vocoder`` packs its decoder's."""
        with torch.inference_mode():
            z, _, _ = vocoder_hifi0.net_prior.prior_latent(mel_t, lens_t, eps_t, 0.667)
            return decoder_apply(vocoder_hifi0.dec_params, z.transpose(1, 2),
                                 vocoder_hifi0.dec_cfg, dtype=torch.bfloat16, hifi_tail=0,
                                 pallas_stage2=True, packed=stage2_packed)

    def stage2(m, e):
        """``stage2_step`` on requests padded to the bucket as mel_to_wav pads them."""
        b, t, _ = m.shape
        pad = ((0, 0), (0, vocoder_hifi0._bucket(t) - t), (0, 0))
        wav = stage2_step(torch.from_numpy(np.pad(m, pad)).to(dev),
                          torch.full((b,), t, dtype=torch.int64, device=dev),
                          torch.from_numpy(np.pad(e, pad)).to(dev))
        wav = wav.float().cpu().numpy()
        return [wav[i, :t * HOP, 0] for i in range(b)]

    def mel_l1(wavs, refs):
        got = mel_spectrogram(torch.from_numpy(np.concatenate(wavs))[None].to(dev), mel_cfg)
        ref = mel_spectrogram(torch.from_numpy(np.concatenate(refs))[None].to(dev), mel_cfg)
        return (got - ref).abs().mean().item()

    vocoder_wn0 = Vocoder(hps, state, dtype=torch.bfloat16, hifi=0, use_wn_kernels=True,
                          buckets=(1000,), device=dev)
    vocoder_wn2 = Vocoder(hps, state, dtype=torch.bfloat16, hifi=2, use_wn_kernels=True,
                          buckets=(1000,), device=dev)
    if not (vocoder_wn0.use_wn_kernels and vocoder_wn2.hifi == 2):
        raise RuntimeError("the WN variants are not routed to their kernels")
    reference = requests(vocoder(vocoder_f32))

    def serve(label, run, kernels, bound, ref=reference):
        """Drive one path with the counts reset just before it; check its
        waveforms, that its kernels launched (their tensor-core bodies: no
        ``*_fma`` launch), and its mel-L1."""
        K.reset_launch_counts()
        served = run()
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        log(f"slice {label}: launches {counts}")
        if not all(counts[k] > 0 for k in kernels) or any(
                v for k, v in counts.items() if k.endswith("_fma")):
            raise RuntimeError(f"{label}: a kernel of the path was not launched, or an FMA "
                               f"body was: {counts}")
        for w, r in zip(served, ref):
            if w.shape != r.shape or not np.isfinite(w).all() or np.abs(w).max() > 1.0:
                raise RuntimeError(f"{label}: bad waveform {w.shape} vs {r.shape}")
        l1 = mel_l1(served, ref)
        log(f"slice {label}: mel-L1 vs plain f32 path {l1:.5f} "
            f"({'bound ' + format(bound, 'g') if bound else 'no bound: printed'})")
        if bound and not l1 <= bound:
            raise RuntimeError(f"{label}: mel-L1 {l1} above {bound}")
        return served, counts, l1

    served, launches, l1_hifi2 = serve("hifi 2", lambda: requests(vocoder(vocoder_hifi2)),
                                       tuple(HIFI2_KERNELS), 1e-2)
    if served[-1].shape != (317 * HOP,):
        raise RuntimeError(f"short request: {served[-1].shape}")
    serve("hifi 0", lambda: requests(vocoder(vocoder_hifi0)), ("mrf_stage", "up_mrf_stage"),
          5e-2)
    _, launches_wn, _ = serve("hifi 0 + WN kernels", lambda: requests(vocoder(vocoder_wn0)),
                              ("wn_stack", "mrf_stage", "up_mrf_stage"), 5e-2)
    serve("hifi 2 + WN kernels (bf16 prior)", lambda: requests(vocoder(vocoder_wn2)),
          ("wn_stack",), None)
    _, launches_s2, _ = serve("pallas_stage2 (decoder_apply)", lambda: requests(stage2),
                              ("mrf_stage_unpacked", "up_mrf_stage"), 5e-2)
    # 1024 frames: stage 1 runs 8192 rows, a multiple of 512, so it takes the
    # unpacked kernel at 256 channels beside stage 2
    mel_1024 = (rng.normal(0, 1, (1, 1024, n_mels)) * 2.0 - 4.0).astype(np.float32)
    eps_1024 = rng.normal(0, 1, (1, 1024, inter)).astype(np.float32)

    _, counts, _ = serve("pallas_stage2 (decoder_apply), 1024 frames",
                         lambda: stage2(mel_1024, eps_1024), ("mrf_stage_unpacked",), 5e-2,
                         vocoder_f32.mel_to_wav(mel_1024, eps=eps_1024))
    per_stage = len(ks) * len(dil)  # one launch per residual pair of each branch
    if counts["mrf_stage_unpacked"] != 2 * per_stage:
        raise RuntimeError(f"stage 1 (256 channels) did not take the unpacked kernel: {counts}")

    log(f"-- phase 5 starts at {time.time() - t_start:.0f} s")
    # 5. timing at B=32 x 1000 frames
    b, frames = 32, 1000
    mel32 = torch.from_numpy((rng.normal(0, 1, (b, frames, n_mels)) * 2.0 - 4.0)
                             .astype(np.float32)).to(dev)
    eps32 = torch.from_numpy(rng.normal(0, 1, (b, frames, inter)).astype(np.float32)).to(dev)
    lens32 = torch.full((b,), frames, dtype=torch.int64, device=dev)
    audio_s = b * frames * HOP / SR
    steps = {}

    def step(voc):
        fn = voc._apply_infer_fast if voc.use_kernels else voc._apply_infer
        return lambda m, n, e: fn(m, n, e, 0.667)

    for label, fn, iters in (("hifi2", step(vocoder_hifi2), 3), ("hifi0", step(vocoder_hifi0), 3),
                             ("hifi0_wn", step(vocoder_wn0), 3), ("pallas_stage2", stage2_step, 2),
                             ("plain_f32", step(vocoder_f32), 3)):
        K.reset_launch_counts()
        fn(mel32, lens32, eps32)
        torch.cuda.synchronize()
        per_step = {k: v for k, v in K.LAUNCHES.items() if v}
        if label in ("hifi2", "hifi0") and per_step != (
                HIFI2_KERNELS if label == "hifi2" else STAGE_KERNELS):
            raise RuntimeError(f"{label}: a step's stage kernels, got {per_step}")
        # the two opt-in paths run their redesigned kernels, and no FMA body
        want = {"hifi0_wn": {"wn_stack": 12, "mrf_stage": 1, "up_mrf_stage": 1},
                "pallas_stage2": {"mrf_stage_unpacked": per_stage, "up_mrf_stage": 2}}
        if label in want and per_step != want[label]:
            raise RuntimeError(f"{label}: launches per step {per_step}, expected {want[label]}")
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(mel32, lens32, eps32)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / iters * 1e3
        steps[label] = ms
        log(f"timing {label}: {ms:.1f} ms/step for B={b} x {frames} frames = "
            f"{audio_s / (ms / 1e3):.1f}x real time, kernel launches per step {per_step}  "
            f"[{card}]")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    for label, fn, rows in (("hifi 2", step(vocoder_hifi2), 20),
                            ("hifi 0 + WN kernels", step(vocoder_wn0), 12),
                            ("pallas_stage2", stage2_step, 12)):
        profile_step(label, lambda: fn(mel32, lens32, eps32), card, rows)

    log(f"-- phase 6 starts at {time.time() - t_start:.0f} s")
    # 6. gate path: the gates of the prior's 16 WN layers under a speaker
    # conditioning, as a conditioned WN would run them; held to the module
    # graph's bf16 gate, which rounds after the add, tanh, sigmoid and product
    # (a few bf16 ulps of an output below 1)
    xh = torch.from_numpy(rng.normal(0, 1, (b, hidden, frames)).astype(np.float32))
    xh = xh.to(dev, torch.bfloat16)
    cond = torch.from_numpy(rng.normal(0, 0.5, (b, len(enc_layers) * 2 * hidden, 1))
                            .astype(np.float32)).to(dev, torch.bfloat16)
    K.reset_launch_counts()
    worst = 0.0
    with torch.inference_mode():
        for i, (w_in, b_in, _, _) in enumerate(enc_layers):
            pre = torch.nn.functional.conv1d(xh, w_in.bfloat16(), b_in.bfloat16(), padding=2)
            g_l = cond[:, i * 2 * hidden:(i + 1) * 2 * hidden]
            acts = fused_gate(pre.transpose(1, 2).contiguous(), g_l.transpose(1, 2))
            want = gated_activation(pre, g_l).transpose(1, 2)
            if acts.shape != want.shape or not torch.isfinite(acts).all():
                raise RuntimeError(f"gate path, layer {i}: bad output {tuple(acts.shape)}")
            worst = max(worst, (acts.float() - want.float()).abs().max().item())
    torch.cuda.synchronize()
    launches_gate = dict(K.LAUNCHES)
    log(f"gate path: {len(enc_layers)} conditioned WN gates at x {(b, frames, 2 * hidden)}, "
        f"launches {launches_gate}, max |fused - module gate| {worst:.3e} (bound 3.2e-2)")
    if launches_gate["fused_gate"] != len(enc_layers) or not worst <= 2.0 ** -5:
        raise RuntimeError("gate path: fused_gate did not launch once per layer or disagrees "
                           "with the module graph's gate")

    log(f"-- phase 7 starts at {time.time() - t_start:.0f} s")
    # 7. training-kernel A/B at full width: iitp_base's training shapes
    if hps.train.batch_size != ab_mrf_train.B:
        raise RuntimeError("the A/B batch is not the config's batch_size")
    log(f"training-kernel A/B (cuDNN autograd vs mrf_stage_train)  [{card}]")
    K.reset_launch_counts()
    ab_rows = ab_mrf_train.main(reps=3, iters=10, device=dev)
    torch.cuda.synchronize()
    launches_ab = dict(K.LAUNCHES)
    log(f"training-kernel A/B: launches {launches_ab}")
    # forward: one kernel per pair; backward, per branch: a replay and a dx step
    # per pair and one weight-gradient launch; no FMA body in bf16
    want = {"mrf_stage_unpacked": len(ks) * len(dil),
            "mrf_branch_bwd": len(ks) * (2 * len(dil) + 1)}
    for row in ab_rows:
        if row["launches"] != want:
            raise RuntimeError(f"A/B stage {row['stage']}: launches {row['launches']}, expected "
                               f"{want} (an *_fma launch is a bf16 call off the tensor cores)")
        if not all(np.isfinite(row[key]) for key in ("autograd_ms", "kernel_ms", "loss_kernel",
                                                     "dx_rel_rms", "dw_rel_rms",
                                                     "autograd_busy_ms", "kernel_busy_ms")):
            raise RuntimeError(f"A/B stage {row['stage']}: {row}")
        # the two legs compute one loss: bf16 rounding moves it in the 4th digit
        if abs(row["loss_kernel"] - row["loss_autograd"]) > 1e-2 * abs(row["loss_autograd"]):
            raise RuntimeError(f"A/B stage {row['stage']}: losses differ: {row}")
    if not (launches_ab["mrf_branch_bwd"] > 0 and launches_ab["mrf_stage_unpacked"] > 0):
        raise RuntimeError(f"the kernel leg did not launch: {launches_ab}")

    log(f"-- phase 8 starts at {time.time() - t_start:.0f} s")
    # 8. the packed-MRF variants at the stage-3 serving shape
    K.reset_launch_counts()
    variants = exp_mrf_variants.main(stage=3, iters=3, device=dev)
    torch.cuda.synchronize()
    launches_var = dict(K.LAUNCHES)
    log(f"variants: launches {launches_var}  [{card}]")
    if launches_var["mrf_stage_variant"] == 0 or launches_var["mrf_stage"] == 0:
        raise RuntimeError(f"the variants did not launch: {launches_var}")
    if not all(np.isfinite(v["ms"]) and np.isfinite(v["chk"]) for v in variants.values()):
        raise RuntimeError(f"variants: {variants}")
    # masking changes the edges only, and the bf16 output of f32 storage moves
    # each value by under one bf16 rounding
    if variants["base"]["chk_central"] != variants["nomask"]["chk_central"]:
        raise RuntimeError(f"nomask differs from base beyond one radius of the ends: {variants}")

    log(f"-- phase 9 starts at {time.time() - t_start:.0f} s")
    # 9. live serving: windows, streams, the multi-stream server, voice conversion
    live_serving(vocoder_hifi2, vocoder_f32, vocoder_wn0, mel_l1, card, rng)

    log(f"-- phase 10 starts at {time.time() - t_start:.0f} s")
    # 10. the training step on the card
    bench = train_step_phase(card, dev, hps,
                             load_config(os.path.join(ROOT, "configs", "iitp_base_ms.json")),
                             rows=hps.train.batch_size)

    log(f"-- phase 11 starts at {time.time() - t_start:.0f} s")
    # 11. the training runtime: corpus, loader, loop, resume, eval, the CLI, NCCL
    torch.cuda.empty_cache()
    configs = {}
    for cfg_name in ("iitp_base", "iitp_base_ms"):
        with open(os.path.join(ROOT, "configs", f"{cfg_name}.json")) as f:
            configs[cfg_name] = json.load(f)
    training_runtime_phase(card, dev, configs["iitp_base"], configs["iitp_base_ms"],
                           bench["legs"]["bf16"]["step_ms"])

    log(f"-- phase 12 starts at {time.time() - t_start:.0f} s")
    # 12. the data axis: two shards on one card; every card and the CLI's ranks
    data_parallel_phase(card, hps, state, vocoder_hifi2, vocoder_f32, mel_l1)

    log(f"-- phase 13 starts at {time.time() - t_start:.0f} s")
    # 13. the model axis: the optimizer state split over a model group of cards
    torch.cuda.empty_cache()
    model_axis_phase(card, hps)

    log(f"-- phase 14 starts at {time.time() - t_start:.0f} s")
    # 14. the headline entry point on the fidelity recipe, held to the fixture
    torch.cuda.empty_cache()
    headline_phase(card, hps)

    log(f"-- phase 15 starts at {time.time() - t_start:.0f} s")
    # 15. the training-evidence tools: corpus, 200 conditioned steps, report, samples
    torch.cuda.empty_cache()
    convergence_tools_phase(card, dev)

    log(f"-- phase 16 starts at {time.time() - t_start:.0f} s")
    # 16. BigVGAN-v2: the fused anti-aliased SnakeBeta, one call at the cell's shapes
    torch.cuda.empty_cache()
    aa = bigvgan_phase(card, dev)

    kernels = [
        {"name": "mrf_stage", "route": "cuda",
         "source": "smart_vocoder_torch/kernels/csrc/mrf_stage.cu",
         "replaces": "smart_vocoder_tpu/kernels/mrf.py:351",
         "launches": launches["mrf_stage"], **records["mrf_stage"]},
        {"name": "up_mrf_stage", "route": "cuda",
         "source": "smart_vocoder_torch/kernels/csrc/mrf_stage.cu",
         "replaces": "smart_vocoder_tpu/kernels/mrf.py:560",
         "launches": launches["up_mrf_stage"], **records["up_mrf_stage"]},
        {"name": "mrf_stage_unpacked", "route": "cuda",
         "source": "smart_vocoder_torch/kernels/csrc/mrf_pair.cu",
         "replaces": "smart_vocoder_tpu/kernels/mrf.py:129",
         "launches": launches_s2["mrf_stage_unpacked"], **records["mrf_stage_unpacked"]},
        {"name": "mrf_stage_unpacked_f32s", "route": "cuda",
         "source": "smart_vocoder_torch/kernels/csrc/mrf_pair.cu",
         "replaces": "smart_vocoder_tpu/kernels/mrf.py:mrf_stage_reference(mixed_f32=True)",
         "launches": launches["mrf_stage_unpacked_f32s"],
         **records["mrf_stage_unpacked_f32s"]},
        {"name": "wn_stack", "route": "cuda",
         "source": "smart_vocoder_torch/kernels/csrc/wn_stack.cu",
         "replaces": "smart_vocoder_tpu/kernels/wn_stack.py:132",
         "launches": launches_wn["wn_stack"], **records["wn_stack"]},
        {"name": "fused_gate", "route": "triton",
         "source": "smart_vocoder_torch/kernels/gate.py",
         "replaces": "smart_vocoder_tpu/kernels/gate.py:23",
         "launches": launches_gate["fused_gate"], **records["fused_gate"]},
        {"name": "mrf_branch_bwd", "route": "cuda",
         "source": "smart_vocoder_torch/kernels/csrc/mrf_train.cu",
         "replaces": "smart_vocoder_tpu/kernels/mrf_train.py:195",
         "launches": launches_ab["mrf_branch_bwd"], **records["mrf_branch_bwd"]},
        {"name": "mrf_stage_variant", "route": "cuda",
         "source": "smart_vocoder_torch/kernels/csrc/mrf_stage.cu",
         "replaces": "scripts/exp_mrf_variants.py:159",
         "launches": launches_var["mrf_stage_variant"], **records["mrf_stage_variant"]},
        {"name": "aa_snake", "route": "cuda",
         "source": "smart_vocoder_torch/kernels/csrc/aa_snake.cu",
         "replaces": "smart_vocoder_torch/models/bigvgan.py:anti_aliased_snake (torch's chain)",
         **aa},
    ]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "ms_min",
            "ms_max", "rounds", "card_ms", "card_ms_min", "card_ms_max", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "tflops", "earlier_ms"}
    for rec in kernels:
        rec["tflops"] = rec.pop("flops") / rec["ms"] / 1e9
        rec.setdefault("earlier_ms", None)
        if set(rec) != keys or rec["launches"] <= 0:
            raise RuntimeError(f"incomplete kernel record: {rec}")
    log(f"-- all phases done at {time.time() - t_start:.0f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

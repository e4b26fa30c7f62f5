"""Smoke run of the PyTorch port on one NVIDIA H100: the serving paths, the
training-kernel A/B and the packed-MRF variants.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: a CUDA card is required; prints its name and power limit.
2. build: compiles the CUDA kernels (smart_vocoder_torch/kernels/csrc) with
   nvcc for sm_90a into smart_vocoder_torch/_build/, and counts the MMA
   instructions in the SASS of every bf16 instantiation of the tensor-core
   kernels: the two stages, the unpacked stage's pair and the WN stack
   (``wgmma`` from 64 channels, ``mma.sync`` at 32).
3. kernels: each kernel against its plain PyTorch version on the card (TF32
   off), at the main-path shapes -- stage 3 x (2, 128000, 64), stage 4
   u (2, 128000, 64) with the conv_post tail; the WN stack at x (32, 1000,
   192) with the 16 prior layers (bf16: each launch of 4 layers on the
   plain version's own state and skip sum; f32, the FMA route: the whole
   stack); the unpacked MRF stage at x (2, 64000, 128) and (1, 8192, 256)
   in bf16 (each faster than its plain version; the f32 FMA route timed at
   the same shape) and a ragged length in bf16 and f32; the stage-3
   fold-up u (2, 64000, 128) -> (2, 128000, 64) -- in the modes the serving
   paths use (stage 3: f32_storage, bf16, x2; stage 4: hifi, bf16), plus
   ragged lengths, and the two stages' f32 FMA route on true-f32 inputs and
   weights; the options of the packed-MRF variants
   (``mask_edges=False``, the bf16 output of f32_storage) at the stage-3
   shapes; the Triton gate at x (32, 1000, 384) with g (32, 1, 384) and
   without, and ragged; the MRF branch backward for k = 3, 7, 11 at the
   training shapes (16, 256, 256), (16, 2048, 128), (16, 4096, 64), (16, 8192,
   32) and a ragged length, in f32 and in bf16: the kernel's replay against
   the plain replay, and its gradients against the plain backward on that
   same replay (the leaky derivative jumps at 0, so on separate replays one
   value within rounding noise of 0 moves a gradient entry by a whole term);
   prints both times.
4. slice: iitp_base at full width, weights from the port's seeded init,
   ``Vocoder.mel_to_wav`` on B=8 x 1000 frames plus one short request padded
   to the bucket, each path with the launch counts reset just before it:
   ``Vocoder(dtype=bf16, hifi=2)`` (mel-L1 against the port's plain f32 path
   <= 1e-2), hifi 0 (<= 5e-2), hifi 0 with ``use_wn_kernels`` (<= 5e-2),
   hifi 2 with it (printed: the reference's bf16-prior combination), and
   ``decoder_apply(pallas_stage2=True)`` on the hifi-0 path's prior latent
   (<= 5e-2), plus one 1024-frame request that routes stage 1 (256
   channels) to the unpacked kernel; each path's kernels must have launched,
   and no f32 FMA body (``*_fma``) on any of them.
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
   of cuDNN autograd against ``mrf_stage_train`` (forward on the tensor
   cores, weights packed per call), interleaved.
8. variants (``tools/exp_mrf_variants.py``): stage 3, x (32, 128000, 64).

Every kernel's record carries its bound: the larger of its operations over
the card's peak for their type (989 TFLOP/s, bf16 tensor cores: every conv
operand is a bf16 value, or a hi/lo pair of them in the F32 modes, which
then count two passes) and its bytes (inputs read once, outputs written once)
over 3.35 TB/s. No single PyTorch call computes an 18-conv stage, a WN stack,
a branch backward or the gate, so ``library_ms`` is null throughout.
``tflops`` is the record's operations over its kernel time. ``earlier_ms``,
for the four kernels and the variant that moved to the tensor cores, is the
time measured in this run of the f32 FMA kernel they replaced (today's route
for true-f32 weights, counted under its own ``*_fma`` name) at the same shape
on f32 inputs; null for the other kernels. The timed calls pass the weights
packed once (``pack_mrf_stage``, ``pack_up_mrf_stage``, ``pack_wn_stack``),
as ``Vocoder`` does.

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


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
                       "wn_stack_mma_kernel")


def sass_mma_counts(so: str) -> dict:
    """MMA instructions in the built library's SASS (``cuobjdump -sass``), per
    instantiation of the tensor-core kernels (the two stages, the unpacked
    stage's pair, the WN stack): {demangled-ish name: {"HGMMA": n, "HMMA": n,
    "FFMA": n}}. ``HGMMA`` is ``wgmma``, ``HMMA`` is ``mma.sync``."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    proc = subprocess.Popen([tool, "-sass", so], stdout=subprocess.PIPE, text=True)
    counts, current = {}, None
    for line in proc.stdout:
        if "Function :" in line:
            m = re.search(rf"\d+({'|'.join(TENSOR_CORE_KERNELS)})((?:ILi\d+E|Li\d+E)+)", line)
            current = None
            if m:
                current = f"{m.group(1)}<{', '.join(re.findall(r'Li(\d+)E', m.group(2)))}>"
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
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

    # 2. build
    t0 = time.time()
    so = build()
    log(f"build: {time.time() - t0:.1f} s -> {os.path.relpath(so, ROOT)}")
    # every bf16 instantiation of the tensor-core kernels runs its convs on the
    # tensor cores: wgmma from 64 channels (the WN stack's 192 too), mma.sync at 32
    sass = sass_mma_counts(str(so))
    for kernel, ops in sorted(sass.items()):
        log(f"  sass {kernel}: {ops}")
        params = kernel.split("<")[1].rstrip(">").split(", ")
        # <[Cin,] C, mode> for the stages, <C> for the pair and the WN stack
        c = int(params[-2] if kernel.startswith(("mrf_stage", "up_mrf")) else params[0])
        wgmma = c >= 64
        if ops["HGMMA" if wgmma else "HMMA"] == 0 or ops["HMMA" if wgmma else "HGMMA"] != 0:
            raise RuntimeError(f"{kernel}: not the MMA its channel count takes: {ops}")
    if len(sass) != 15:
        raise RuntimeError("expected the 6 + 4 instantiations of the stage kernels, 4 of the "
                           f"unpacked stage's pair and 1 of the WN stack: {sass}")

    hps = load_config(os.path.join(ROOT, "configs", "iitp_base.json"))
    net = init_synthesizer(build_synthesizer(hps, weight_norm=True), SEED)
    state = {k: v.detach() for k, v in net.state_dict().items()}
    del net
    vocoder_hifi2 = Vocoder(hps, state, dtype=torch.bfloat16, hifi=2, buckets=(1000,),
                            device=dev)
    dec = vocoder_hifi2.dec_params
    ks = tuple(hps.model.resblock_kernel_sizes)
    dil = tuple(hps.model.resblock_dilation_sizes[0])

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
                rec["ms"] = cuda_ms(lambda: K.mrf_stage(xb, br, ks, dil, packed=packed, **kw), 5)
                rec["plain_ms"] = cuda_ms(lambda: K.mrf_stage_plain(xb, br, ks, dil, mode), 5)
                rec.update(bound(mrf_flops(*x.shape, ks, len(dil)), [xb, got, *sum(br, ())]))
                log(f"  mrf_stage {tuple(x.shape)} f32_storage: kernel {rec['ms']:.2f} ms, "
                    f"plain {rec['plain_ms']:.2f} ms, bound {rec['bound_ms']:.3f} ms  [{card}]")
            elif t == 128000:
                ms = cuda_ms(lambda: K.mrf_stage(xb, br, ks, dil, packed=packed, **kw), 5)
                log(f"  {tag}: kernel {ms:.2f} ms  [{card}]")
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
                rec["earlier_ms"] = cuda_ms(lambda: K.mrf_stage(x, br32, ks, dil, **kw), 3)
                log(f"  {tag}: kernel {rec['earlier_ms']:.2f} ms  [{card}]")
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
                rec["ms"] = cuda_ms(lambda: K.mrf_stage(xb, br, ks, dil, packed=packed, **kw), 5)
                rec["plain_ms"] = cuda_ms(
                    lambda: K.mrf_stage_plain(xb, br, ks, dil, mode, mask_edges, True), 5)
                rec.update(bound(mrf_flops(*x.shape, ks, len(dil)), [xb, got, *sum(br, ())]))
                log(f"  mrf_stage {tuple(x.shape)} nomask: kernel {rec['ms']:.2f} ms, "
                    f"plain {rec['plain_ms']:.2f} ms, bound {rec['bound_ms']:.3f} ms  [{card}]")
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
                rec["ms"] = cuda_ms(lambda: K.up_mrf_stage(
                    uu, args[0], args[1], 4, 2, 1, brr, ks, dil, post_weight=pw, hifi=True,
                    packed=up_packed), 5)
                rec["plain_ms"] = cuda_ms(lambda: K.up_mrf_stage_plain(uu, *args, mode, pw), 5)
                # hifi: f32 activations as hi + lo bf16 pairs, so two tensor-core passes
                b_, tu_, cin_ = uu.shape
                flops = 2 * (mrf_flops(b_, 2 * tu_, 32, ks, len(dil))
                             + 2.0 * 4 * cin_ * 32 * tu_ * b_ + 2.0 * 7 * 32 * 2 * tu_ * b_)
                rec.update(bound(flops, [uu, got, args[0], pw, *sum(brr, ())]))
                log(f"  up_mrf_stage {tuple(uu.shape)} hifi+post: kernel {rec['ms']:.2f} ms, "
                    f"plain {rec['plain_ms']:.2f} ms, bound {rec['bound_ms']:.3f} ms  [{card}]")
            elif t == 128000:
                ms = cuda_ms(lambda: K.up_mrf_stage(uu, args[0], args[1], 4, 2, 1, brr, ks, dil,
                                                    post_weight=pw, packed=up_packed), 5)
                log(f"  {tag}+post: kernel {ms:.2f} ms  [{card}]")
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
            rec["earlier_ms"] = cuda_ms(lambda: K.up_mrf_stage(
                u, args[0], args[1], 4, 2, 1, brr, ks, dil, post_weight=post.float()), 3)
            log(f"  {tag}: kernel {rec['earlier_ms']:.2f} ms  [{card}]")
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
                ms = cuda_ms(lambda: K.mrf_stage_unpacked(xd, br, ks, dil, packed=packed), 5)
                plain = cuda_ms(lambda: K.mrf_stage_plain(xd, br, ks, dil, mode), 3)
                x32, br32 = x.float(), stage_branches(stage, torch.float32)
                earlier = cuda_ms(lambda: K.mrf_stage_unpacked(x32, br32, ks, dil), 1)
                bnd = bound(mrf_flops(*shape, ks, len(dil)), [xd, got, *sum(br, ())])
                log(f"  {tag}: kernel {ms:.3f} ms ({bnd['flops'] / ms / 1e9:.1f} TFLOP/s), "
                    f"plain {plain:.2f} ms, bound {bnd['bound_ms']:.3f} ms, f32 FMA route "
                    f"{earlier:.2f} ms  [{card}]")
                if not ms < plain:
                    raise RuntimeError(f"{tag}: the kernel is not faster than its plain version")
                if shape == (2, 64000, 128):
                    rec.update(ms=ms, plain_ms=plain, earlier_ms=earlier, **bnd)
                del x32, br32
        del x, xd, got, want, exact
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
            ms = cuda_ms(lambda: K.up_mrf_stage(ub, args[0], args[1], 4, 2, 1, brr, ks, dil,
                                                packed=up_packed), 3)
            plain = cuda_ms(lambda: K.up_mrf_stage_plain(ub, *args, K.BF16), 3)
            bnd = bound(mrf_flops(2, 2 * tu, 64, ks, len(dil)) + 2.0 * 4 * 128 * 64 * tu * 2,
                        [ub, got, args[0], *sum(brr, ())])
            log(f"  {tag}: kernel {ms:.2f} ms, plain {plain:.2f} ms, bound "
                f"{bnd['bound_ms']:.3f} ms  [{card}]")
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
            times = {}
            for xd, pk in ((xb, packed), (x, pack_wn_stack(enc_layers, hidden, torch.float32,
                                                           lpc, dev))):
                ms = cuda_ms(lambda: wn_stack(xd, mask, enc_layers, hidden, lpc, pk), 5)
                plain = cuda_ms(lambda: wn_stack_plain(xd, mask, enc_layers, hidden, lpc), 3)
                times[xd.dtype] = ms, plain
                log(f"  wn_stack {tuple(x.shape)} x{len(enc_layers)} layers "
                    f"{'bf16' if xd.dtype == torch.bfloat16 else 'f32 (FMA route)'}: kernel "
                    f"{ms:.3f} ms, plain {plain:.2f} ms  [{card}]")
            ms, plain = times[torch.bfloat16]
            if not ms < plain:
                raise RuntimeError("wn_stack bf16: the kernel is not faster than its plain version")
            n_l = len(enc_layers)  # k=5 conv H -> 2H, then 1x1 to 2H (H in the last)
            flops = 2.0 * b * t * hidden * hidden * (12 * n_l - 1)
            records["wn_stack"].update(ms=ms, plain_ms=plain, earlier_ms=times[torch.float32][0],
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
            if gshape == (32, 1, 384) and dt == torch.bfloat16:
                rec["ms"] = cuda_ms(lambda: fused_gate(x, g), 20)
                rec["plain_ms"] = cuda_ms(lambda: fused_gate_plain(x, g), 20)
                rec.update(bound(12.0 * got.numel(), [x, g, got]))
                log(f"  fused_gate {shape} bf16: kernel {rec['ms']:.4f} ms, plain "
                    f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms  [{card}]")

    # the MRF branch backward at the training shapes (B = 16 segments of 32
    # frames) and a ragged length. The replay (x_j, h_j) is held to the plain
    # replay, then dx and the four weight gradients to the plain backward on
    # the kernel's own replay, so both take the same arm of the leaky
    # derivative everywhere. f32: replay within 1e-4 and gradients within 1e-3
    # of their largest entry. bf16: through `compare`, with the f32 plain
    # version on the same bf16 values (and the same replay) as `exact`.
    parts = ("dx", "dw1", "db1", "dw2", "db2")
    for stage, shape in ((0, (16, 256, 256)), (1, (16, 2048, 128)), (2, (16, 4096, 64)),
                         (3, (16, 8192, 32)), (2, (2, 1237, 64))):
        x = torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            xd, gd, br = x.to(dt), g.to(dt), stage_branches(stage, dt)
            for branch, k in zip(br, ks):
                tag = f"mrf_branch_bwd {shape} k={k} {str(dt)[6:]}"
                dx, dws, replay = mrf_branch_bwd(xd, gd, branch, k, dil, with_replay=True)
                torch.cuda.synchronize()
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
            if shape == (16, 2048, 128) and dt == torch.bfloat16:
                rec = records["mrf_branch_bwd"]
                rec["ms"] = cuda_ms(lambda: [mrf_branch_bwd(xd, gd, b_, k, dil)
                                             for b_, k in zip(br, ks)], 3)
                rec["plain_ms"] = cuda_ms(lambda: [mrf_branch_bwd_plain(xd, gd, b_, k, dil)
                                                   for b_, k in zip(br, ks)], 3)
                # per branch: 5 replayed convs, 6 dx convs, 6 dw products
                flops = 17 / 6 * mrf_flops(*shape, ks, len(dil))
                rec.update(bound(flops, [xd, gd] * len(ks) + [xd] * len(ks)
                                 + [a for b_ in br for a in b_] * 2))
                log(f"  mrf_branch_bwd {shape} bf16, the three branches: kernel {rec['ms']:.2f} "
                    f"ms, plain {rec['plain_ms']:.2f} ms, bound {rec['bound_ms']:.3f} ms  "
                    f"[{card}]")
        del x, g, xd, gd, dx, dws, wdx, wdws, replay, want_replay, steps, got

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
                                       ("mrf_stage", "up_mrf_stage"), 1e-2)
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
        if label in ("hifi2", "hifi0") and per_step != {"mrf_stage": 1, "up_mrf_stage": 1}:
            raise RuntimeError(f"{label}: a step is one launch of each stage kernel, got "
                               f"{per_step}")
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

    # 7. training-kernel A/B at full width: iitp_base's training shapes
    if hps.train.batch_size != ab_mrf_train.B:
        raise RuntimeError("the A/B batch is not the config's batch_size")
    log(f"training-kernel A/B (cuDNN autograd vs mrf_stage_train)  [{card}]")
    K.reset_launch_counts()
    ab_rows = ab_mrf_train.main(reps=3, iters=10, device=dev)
    torch.cuda.synchronize()
    launches_ab = dict(K.LAUNCHES)
    log(f"training-kernel A/B: launches {launches_ab}")
    per_step = len(ks) * len(dil)  # forward: one kernel per pair; backward: two
    for row in ab_rows:
        if row["launches"] != {"mrf_stage_unpacked": per_step, "mrf_branch_bwd": 2 * per_step}:
            raise RuntimeError(f"A/B stage {row['stage']}: launches {row['launches']}")
        if not all(np.isfinite(row[key]) for key in ("autograd_ms", "kernel_ms", "loss_kernel",
                                                     "dx_rel_rms", "dw_rel_rms",
                                                     "autograd_busy_ms", "kernel_busy_ms")):
            raise RuntimeError(f"A/B stage {row['stage']}: {row}")
        # the two legs compute one loss: bf16 rounding moves it in the 4th digit
        if abs(row["loss_kernel"] - row["loss_autograd"]) > 1e-2 * abs(row["loss_autograd"]):
            raise RuntimeError(f"A/B stage {row['stage']}: losses differ: {row}")
    if not (launches_ab["mrf_branch_bwd"] > 0 and launches_ab["mrf_stage_unpacked"] > 0):
        raise RuntimeError(f"the kernel leg did not launch: {launches_ab}")

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
    ]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "tflops", "earlier_ms"}
    for rec in kernels:
        rec["tflops"] = rec.pop("flops") / rec["ms"] / 1e9
        rec.setdefault("earlier_ms", None)
        if set(rec) != keys or rec["launches"] <= 0:
            raise RuntimeError(f"incomplete kernel record: {rec}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

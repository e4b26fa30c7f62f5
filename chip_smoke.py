"""Smoke run of the PyTorch port's serving path on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: a CUDA card is required; prints its name and power limit.
2. build: compiles the CUDA kernels (smart_vocoder_torch/kernels/csrc) with
   nvcc for sm_90a into smart_vocoder_torch/_build/.
3. kernels: each kernel against its plain PyTorch version on the card (TF32
   off), at the main-path shapes -- stage 3 x (2, 128000, 64), stage 4
   u (2, 128000, 64) with the conv_post tail; the WN stack at x (32, 1000,
   192) with the 16 prior layers (bf16: each launch of 4 layers on the
   plain version's own state and skip sum; f32: the whole stack); the
   unpacked MRF stage at x (2, 64000, 128) and (1, 8192, 256); the stage-3
   fold-up u (2, 64000, 128) -> (2, 128000, 64) -- in the modes the serving
   paths use, plus ragged lengths; prints both times.
4. slice: iitp_base at full width, weights from the port's seeded init,
   ``Vocoder.mel_to_wav`` on B=8 x 1000 frames plus one short request padded
   to the bucket, each path with the launch counts reset just before it:
   ``Vocoder(dtype=bf16, hifi=2)`` (mel-L1 against the port's plain f32 path
   <= 1e-2), hifi 0 (<= 5e-2), hifi 0 with ``use_wn_kernels`` (<= 5e-2),
   hifi 2 with it (printed: the reference's bf16-prior combination), and
   ``decoder_apply(pallas_stage2=True)`` on the hifi-0 path's prior latent
   (<= 5e-2), plus one 1024-frame request that routes stage 1 (256
   channels) to the unpacked kernel; each path's kernels must have launched.
5. timing: B=32 x 1000 frames (bench.py's protocol: warm-up, iterations,
   synchronize) for hifi 2, hifi 0, hifi 0 + WN kernels, the pallas_stage2
   route and the plain f32 path, and a profiler breakdown of the hifi-2 step
   by kernel and of the two new paths.

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
    from smart_vocoder_torch.kernels._build import build
    from smart_vocoder_torch.kernels.decoder import _stage_branches, decoder_apply
    from smart_vocoder_torch.kernels.wn_stack import (
        pack_wn_stack,
        wn_chunk,
        wn_chunk_plain,
        wn_layers_from_state_dict,
        wn_stack,
        wn_stack_plain,
    )
    from smart_vocoder_torch.models import build_synthesizer
    from smart_vocoder_torch.ops import MelConfig, mel_spectrogram
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
        exact = K.mrf_stage_plain(xb, br, ks, dil, K.F32)
        for mode, kw in ((K.F32_STORAGE, {"f32_storage": True}), (K.BF16, {})):
            tag = f"mrf_stage {tuple(x.shape)} {'f32_storage' if kw else 'bf16'}"
            got = K.mrf_stage(xb, br, ks, dil, **kw)
            want = K.mrf_stage_plain(xb, br, ks, dil, mode)
            err = compare(tag, got, want, exact, False)
            rec = records.setdefault("mrf_stage", {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if t == 128000 and mode == K.F32_STORAGE:
                rec["ms"] = cuda_ms(lambda: K.mrf_stage(xb, br, ks, dil, **kw), 5)
                rec["plain_ms"] = cuda_ms(lambda: K.mrf_stage_plain(xb, br, ks, dil, mode), 5)
                log(f"  mrf_stage {tuple(x.shape)} f32_storage: kernel {rec['ms']:.2f} ms, "
                    f"plain {rec['plain_ms']:.2f} ms  [{card}]")
        u = x  # stage 4 input: (B, Tu, 64) -> (B, 2*Tu, 1)
        up_w, up_b = dec["ups.3.weight"], dec["ups.3.bias"]
        post = dec["conv_post.weight"]
        for mode, hifi in ((K.F32, True), (K.BF16, False)):
            wdt = torch.bfloat16
            brr = stage_branches(3, wdt)
            uu = u if hifi else u.bfloat16()
            args = (up_w.to(wdt).float(), up_b.to(wdt).float(), 2, 1, brr, ks, dil)
            pw = post.to(wdt).float()
            tag = f"up_mrf_stage {tuple(uu.shape)} {'hifi' if hifi else 'bf16'}"
            got = K.up_mrf_stage(uu, args[0], args[1], 4, 2, 1, brr, ks, dil,
                                 post_weight=pw, hifi=hifi)
            want = K.up_mrf_stage_plain(uu, *args, mode, pw)
            exact = K.up_mrf_stage_plain(uu, *args, K.F32, pw)
            err = compare(tag, got, want, exact, mode == K.F32)
            rec = records.setdefault("up_mrf_stage", {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if t == 128000 and hifi:
                rec["ms"] = cuda_ms(lambda: K.up_mrf_stage(
                    uu, args[0], args[1], 4, 2, 1, brr, ks, dil, post_weight=pw, hifi=True), 5)
                rec["plain_ms"] = cuda_ms(lambda: K.up_mrf_stage_plain(uu, *args, mode, pw), 5)
                log(f"  up_mrf_stage {tuple(uu.shape)} hifi+post: kernel {rec['ms']:.2f} ms, "
                    f"plain {rec['plain_ms']:.2f} ms  [{card}]")
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
            got = K.mrf_stage_unpacked(xd, br, ks, dil)
            want = K.mrf_stage_plain(xd, br, ks, dil, mode)
            exact = K.mrf_stage_plain(xd, br, ks, dil, K.F32)
            rec = record("mrf_stage_unpacked", compare(tag, got, want, exact, mode == K.F32,
                                                       ulp_slack=True))
            if shape == (2, 64000, 128):
                rec["ms"] = cuda_ms(lambda: K.mrf_stage_unpacked(xd, br, ks, dil), 3)
                rec["plain_ms"] = cuda_ms(lambda: K.mrf_stage_plain(xd, br, ks, dil, mode), 3)
                log(f"  {tag}: kernel {rec['ms']:.2f} ms, plain {rec['plain_ms']:.2f} ms  "
                    f"[{card}]")
            elif shape[2] == 256:
                log(f"  {tag}: kernel {cuda_ms(lambda: K.mrf_stage_unpacked(xd, br, ks, dil), 3):.2f}"
                    f" ms, plain {cuda_ms(lambda: K.mrf_stage_plain(xd, br, ks, dil, mode), 3):.2f}"
                    f" ms  [{card}]")
        del x, xd, got, want, exact
    up_w, up_b = dec["ups.2.weight"], dec["ups.2.bias"]
    for tu in (64000, 4321):
        u = torch.from_numpy(rng.normal(0, 0.5, (2, tu, 128)).astype(np.float32)).to(dev)
        ub, brr = u.bfloat16(), stage_branches(2, torch.bfloat16)
        args = (up_w.bfloat16().float(), up_b.bfloat16().float(), 2, 1, brr, ks, dil)
        tag = f"up_mrf_stage {tuple(ub.shape)} 128->64 bf16"
        got = K.up_mrf_stage(ub, args[0], args[1], 4, 2, 1, brr, ks, dil)
        want = K.up_mrf_stage_plain(ub, *args, K.BF16)
        exact = K.up_mrf_stage_plain(ub, *args, K.F32)
        record("up_mrf_stage", compare(tag, got, want, exact, False))
        if tu == 64000:
            ms = cuda_ms(lambda: K.up_mrf_stage(ub, args[0], args[1], 4, 2, 1, brr, ks, dil), 3)
            plain = cuda_ms(lambda: K.up_mrf_stage_plain(ub, *args, K.BF16), 3)
            log(f"  {tag}: kernel {ms:.2f} ms, plain {plain:.2f} ms  [{card}]")
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
        for n, chunk in enumerate(chunks):
            final = n == len(chunks) - 1
            got = wn_chunk(carry, mask, chunk, hidden, skip, final, packed[n])
            want = wn_chunk_plain(carry, mask, chunk, hidden, skip, final)
            exact = wn_chunk_plain(carry.float(), mask,
                                   [tuple(a.bfloat16().float() for a in lay) for lay in chunk],
                                   hidden, skip.float(), final)
            tag = f"wn_stack {tuple(x.shape)} bf16 launch {n + 1}/{len(chunks)}"
            for part, g, w, e in zip(("state", "skip sum"), got, want, exact):
                record("wn_stack", compare(f"{tag} {part}", g, w, e, False, ulp_slack=True))
            carry, skip = want
        got = wn_stack(x, mask, enc_layers, hidden, lpc)
        want = wn_stack_plain(x, mask, enc_layers, hidden, lpc)
        record("wn_stack", compare(f"wn_stack {tuple(x.shape)} x{len(enc_layers)} layers f32",
                                   got, want, want, True))
        if b == 32:
            for xd, pk in ((xb, packed), (x, pack_wn_stack(enc_layers, hidden, torch.float32,
                                                           lpc, dev))):
                ms = cuda_ms(lambda: wn_stack(xd, mask, enc_layers, hidden, lpc, pk), 3)
                plain = cuda_ms(lambda: wn_stack_plain(xd, mask, enc_layers, hidden, lpc), 3)
                bf = xd.dtype == torch.bfloat16
                log(f"  wn_stack {tuple(x.shape)} x{len(enc_layers)} layers "
                    f"{'bf16' if bf else 'f32'}: kernel {ms:.2f} ms, plain {plain:.2f} ms  [{card}]")
                if bf:
                    records["wn_stack"]["ms"], records["wn_stack"]["plain_ms"] = ms, plain
        del x, xb, carry, skip, got, want, exact

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

    def stage2_step(mel_t, lens_t, eps_t):
        """The pallas_stage2 route as scripts/exp_stage2_e2e.py drives it:
        the hifi-0 path's prior latent, then decoder_apply(pallas_stage2=True)."""
        with torch.inference_mode():
            z, _, _ = vocoder_hifi0.net_prior.prior_latent(mel_t, lens_t, eps_t, 0.667)
            return decoder_apply(vocoder_hifi0.dec_params, z.transpose(1, 2),
                                 vocoder_hifi0.dec_cfg, dtype=torch.bfloat16, hifi_tail=0,
                                 pallas_stage2=True)

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
        waveforms, that its kernels launched, and its mel-L1."""
        K.reset_launch_counts()
        served = run()
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        log(f"slice {label}: launches {counts}")
        if not all(counts[k] > 0 for k in kernels):
            raise RuntimeError(f"{label}: a kernel of the path was not launched: {counts}")
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
        fn(mel32, lens32, eps32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(mel32, lens32, eps32)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / iters * 1e3
        steps[label] = ms
        log(f"timing {label}: {ms:.1f} ms/step for B={b} x {frames} frames = "
            f"{audio_s / (ms / 1e3):.1f}x real time  [{card}]")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    for label, fn, rows in (("hifi 2", step(vocoder_hifi2), 20),
                            ("hifi 0 + WN kernels", step(vocoder_wn0), 8),
                            ("pallas_stage2", stage2_step, 8)):
        profile_step(label, lambda: fn(mel32, lens32, eps32), card, rows)

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
         "source": "smart_vocoder_torch/kernels/csrc/mrf_stage.cu",
         "replaces": "smart_vocoder_tpu/kernels/mrf.py:129",
         "launches": launches_s2["mrf_stage_unpacked"], **records["mrf_stage_unpacked"]},
        {"name": "wn_stack", "route": "cuda",
         "source": "smart_vocoder_torch/kernels/csrc/wn_stack.cu",
         "replaces": "smart_vocoder_tpu/kernels/wn_stack.py:132",
         "launches": launches_wn["wn_stack"], **records["wn_stack"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

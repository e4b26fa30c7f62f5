"""Smoke run of the PyTorch port's serving path on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: a CUDA card is required; prints its name and power limit.
2. build: compiles the CUDA kernels (smart_vocoder_torch/kernels/csrc) with
   nvcc for sm_90a into smart_vocoder_torch/_build/.
3. kernels: each kernel against its plain PyTorch version on the card (TF32
   off), at the main-path shapes -- stage 3 x (2, 128000, 64), stage 4
   u (2, 128000, 64) with the conv_post tail -- in the modes the serving
   levels use, plus a ragged length; prints both times.
4. slice: iitp_base at full width, weights from the port's seeded init,
   ``Vocoder(dtype=bf16, hifi=2).mel_to_wav`` on B=8 x 1000 frames plus one
   short request padded to the bucket; every kernel's launch count must rise;
   mel-L1 against the port's plain f32 path on the same inputs <= 1e-2
   (hifi 0: <= 5e-2).
5. timing: B=32 x 1000 frames (bench.py's protocol: warm-up, iterations,
   synchronize) for hifi 2, hifi 0 and the plain f32 path, and a profiler
   breakdown of the hifi-2 step by kernel.

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


def compare(name, got, want, exact, mode_f32: bool) -> float:
    """Kernel output against its plain version. F32 modes: max |diff| <= 1e-3
    (f32 summation order; every value is a tanh output or O(1) activation).
    bf16-rounding modes: the two round at the same points, but summation
    order flips a rounding now and then and the chains carry it; the mean
    |diff| must stay under half, and the max under all, of what bf16 costs
    against the F32 result on the same inputs."""
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
        ok = diff.mean().item() < 0.5 * cost.mean().item() and err <= cost.max().item()
        detail = (f"mean {diff.mean().item():.3e} vs bf16 cost {cost.mean().item():.3e}, "
                  f"max {err:.3e} vs {cost.max().item():.3e}")
    log(f"  {name}: {detail} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version ({detail})")
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, ROOT)
    from smart_vocoder_torch.config import load_config
    from smart_vocoder_torch.inference import Vocoder, set_precision_flags
    from smart_vocoder_torch.kernels import mrf as K
    from smart_vocoder_torch.kernels._build import build
    from smart_vocoder_torch.kernels.decoder import _stage_branches
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

    def requests(voc):
        return voc.mel_to_wav(mel, eps=eps) + voc.mel_to_wav(short_mel, eps=short_eps)

    def mel_l1(wavs, refs):
        got = mel_spectrogram(torch.from_numpy(np.concatenate(wavs))[None].to(dev), mel_cfg)
        ref = mel_spectrogram(torch.from_numpy(np.concatenate(refs))[None].to(dev), mel_cfg)
        return (got - ref).abs().mean().item()

    reference = requests(vocoder_f32)
    K.reset_launch_counts()
    served = requests(vocoder_hifi2)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    log(f"slice hifi 2: launches {launches}")
    if not all(launches[k] > 0 for k in ("mrf_stage", "up_mrf_stage")):
        raise RuntimeError(f"a kernel of the path was not launched: {launches}")
    for w, r in zip(served, reference):
        if w.shape != r.shape or not np.isfinite(w).all() or np.abs(w).max() > 1.0:
            raise RuntimeError(f"bad waveform {w.shape} vs {r.shape}")
    if served[-1].shape != (317 * HOP,):
        raise RuntimeError(f"short request: {served[-1].shape}")
    l1_hifi2 = mel_l1(served, reference)
    log(f"slice hifi 2: mel-L1 vs plain f32 path {l1_hifi2:.5f} (bound 1e-2)")
    if not l1_hifi2 <= 1e-2:
        raise RuntimeError(f"hifi 2 mel-L1 {l1_hifi2}")
    K.reset_launch_counts()
    served0 = requests(vocoder_hifi0)
    if not all(v > 0 for v in K.LAUNCHES.values()):
        raise RuntimeError(f"hifi 0 skipped a kernel: {K.LAUNCHES}")
    l1_hifi0 = mel_l1(served0, reference)
    log(f"slice hifi 0: mel-L1 vs plain f32 path {l1_hifi0:.5f} (bound 5e-2)")
    if not l1_hifi0 <= 5e-2:
        raise RuntimeError(f"hifi 0 mel-L1 {l1_hifi0}")

    # 5. timing at B=32 x 1000 frames
    b, frames = 32, 1000
    mel32 = torch.from_numpy((rng.normal(0, 1, (b, frames, n_mels)) * 2.0 - 4.0)
                             .astype(np.float32)).to(dev)
    eps32 = torch.from_numpy(rng.normal(0, 1, (b, frames, inter)).astype(np.float32)).to(dev)
    lens32 = torch.full((b,), frames, dtype=torch.int64, device=dev)
    audio_s = b * frames * HOP / SR
    steps = {}
    for label, voc in (("hifi2", vocoder_hifi2), ("hifi0", vocoder_hifi0),
                       ("plain_f32", vocoder_f32)):
        fn = voc._apply_infer_fast if voc.use_kernels else voc._apply_infer
        fn(mel32, lens32, eps32, 0.667)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn(mel32, lens32, eps32, 0.667)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        steps[label] = ms
        log(f"timing {label}: {ms:.1f} ms/step for B={b} x {frames} frames = "
            f"{audio_s / (ms / 1e3):.1f}x real time  [{card}]")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        vocoder_hifi2._apply_infer_fast(mel32, lens32, eps32, 0.667)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # device-side events only: an aten op's row repeats its kernels' time
    busy_ms = sum(e.self_device_time_total for e in averages
                  if e.device_type == DeviceType.CUDA) / 1e3
    log(f"profiled hifi-2 step: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%)  [{card}]")
    table = averages.table(sort_by="self_device_time_total", row_limit=20)
    log("profile (hifi 2, one step, top kernels by device time):")
    for line in table.splitlines():
        log("  " + line)

    kernels = [
        {"name": "mrf_stage", "route": "cuda",
         "source": "smart_vocoder_torch/kernels/csrc/mrf_stage.cu",
         "replaces": "smart_vocoder_tpu/kernels/mrf.py:351",
         "launches": launches["mrf_stage"], **records["mrf_stage"]},
        {"name": "up_mrf_stage", "route": "cuda",
         "source": "smart_vocoder_torch/kernels/csrc/mrf_stage.cu",
         "replaces": "smart_vocoder_tpu/kernels/mrf.py:560",
         "launches": launches["up_mrf_stage"], **records["up_mrf_stage"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Same-process A/B of the two MMA bodies of the tensor-core MRF stages.

``csrc/mrf_mma.cuh`` runs the GEMMs of 64 channels on ``wgmma`` and those of
32 channels on ``mma.sync``. This tool builds ``csrc/mrf_stage.cu`` twice, as
it is (``tree``) and with ``kWgmmaC = 0``, which sends every channel count to
the ``mma.sync`` body (``mma_sync``), and runs both at the serving shapes:
stage 3 x (2, T, 64) in f32_storage, bf16 and x2, stage 4 u (2, T, 64) with
the tail under hifi, and the stage-3 fold-up u (2, T / 2, 128) in bf16 and
under hifi. Each result is held to the plain version (max |diff| printed);
times are device ms over 5 launches, the builds interleaved, ROUNDS times
(every other round in reverse order), then each leg's median and range. With
a second argument, the root of another checkout (an earlier commit unpacked
with ``git archive``), its ``mrf_stage.cu`` is built as a third leg
(``other``), so a change to the shared helpers is timed against its parent in
one call; the tool then also compares the SASS (``cuobjdump -sass``) of every
kernel of the ``tree`` and ``other`` builds, instruction by instruction, and
says which kernels differ.

    python -m smart_vocoder_torch.tools.ab_stage_mma [T [CHECKOUT [ROUNDS]]]
                                                       (T: 128000, ROUNDS: 2)

Needs the card and ``nvcc``; builds into ``smart_vocoder_torch/_build/ab/``.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from smart_vocoder_torch.kernels import _build
from smart_vocoder_torch.kernels import mrf as K

KS, DIL = (3, 7, 11), (1, 3, 5)
VARIANTS = {"tree": K.WGMMA_CHANNELS, "mma_sync": 0}  # name -> kWgmmaC


def build_variants(variants: dict[str, int | None],
                   src_dirs: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """One shared library of ``csrc/mrf_stage.cu`` per variant: a copy of the
    sources (this package's, or ``src_dirs[name]``) with ``kWgmmaC`` set to
    the variant's value (None: as they are); all nvcc runs at once."""
    out = _build.BUILD_DIR / "ab"
    procs = {}
    for name, wgmma_c in variants.items():
        src = out / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(src_dirs.get(name, _build.SRC_DIR), src)
        if wgmma_c is not None:
            header = src / "mrf_mma.cuh"
            text = header.read_text()
            marker = f"kWgmmaC = {K.WGMMA_CHANNELS};"
            if marker not in text:
                raise RuntimeError(f"{header}: no '{marker}'")
            header.write_text(text.replace(marker, f"kWgmmaC = {wgmma_c};"))
        so = out / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(src / "mrf_stage.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        for entry in ("svt_mrf_stage", "svt_up_mrf_stage"):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = _build._SIGNATURES[entry], ctypes.c_int
        libs[name] = lib
    return libs


def sass(so: Path) -> dict[str, list[str]]:
    """Each kernel's SASS in a built library: {mangled name: instructions},
    without addresses and encodings, and without the hash that names a
    source's anonymous namespace (it differs from build to build)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", text)
    kernels: dict[str, list[str]] = {}
    current = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = kernels.setdefault(m.group(1), [])
        elif current is not None:
            ins = re.sub(r"/\*.*?\*/", "", line).strip()
            if ins:
                current.append(ins)
    return kernels


def compare_sass(a: Path, b: Path) -> bool:
    """Prints, for each kernel of either library, whether its SASS is the
    same in both; True when every kernel's is."""
    ka, kb = sass(a), sass(b)
    same = True
    for name in sorted(set(ka) | set(kb)):
        la, lb = ka.get(name), kb.get(name)
        if la == lb:
            verdict = f"identical ({len(la)} instructions)"
        else:
            same = False
            verdict = ("only in one build" if la is None or lb is None else
                       f"differs ({len(la)} against {len(lb)} instructions, "
                       f"{sum(x != y for x, y in zip(la, lb))} differ in place)")
        print(f"SASS {name}: {verdict}", flush=True)
    print(f"SASS of {a.name} and {b.name}: {'identical' if same else 'different'}", flush=True)
    return same


def device_ms(fn, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(t: int = 128000, other: str | None = None,
         rounds: int = 2) -> dict[str, dict[str, float]]:
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)

    def normal(shape, scale):  # bf16 values held in f32
        return (torch.randn(shape, generator=gen, device=dev) * scale).bfloat16().float()

    def branches(c, scale):
        return [tuple(normal(s, scale) for s in ((3, k, c, c), (3, c), (3, k, c, c), (3, c)))
                for k in KS]

    x = torch.randn((2, t, 64), generator=gen, device=dev) * 0.5
    xb = x.bfloat16()
    u5 = torch.randn((2, t // 2, 128), generator=gen, device=dev) * 0.5
    br3, br4 = branches(64, 0.02), branches(32, 0.03)
    up4, b4, post = normal((64, 32, 4), 0.05), normal((32,), 0.05), normal((1, 32, 7), 0.05)
    up5, b5 = normal((128, 64, 4), 0.05), normal((64,), 0.05)
    cases = {  # label -> (kernel call given the packed weights, plain result)
        "s3 f32_storage": (lambda p: K.mrf_stage(xb, br3, KS, DIL, f32_storage=True, packed=p[0]),
                           K.mrf_stage_plain(xb, br3, KS, DIL, K.F32_STORAGE)),
        "s3 bf16": (lambda p: K.mrf_stage(xb, br3, KS, DIL, packed=p[0]),
                    K.mrf_stage_plain(xb, br3, KS, DIL, K.BF16)),
        "s3 x2": (lambda p: K.mrf_stage(xb, br3, KS, DIL, x2=True, packed=p[0]),
                  K.mrf_stage_plain(xb, br3, KS, DIL, K.F32)),
        "s4 hifi+post": (lambda p: K.up_mrf_stage(x, up4, b4, 4, 2, 1, br4, KS, DIL,
                                                  post_weight=post, hifi=True, packed=p[1]),
                         K.up_mrf_stage_plain(x, up4, b4, 2, 1, br4, KS, DIL, K.F32, post)),
        "128->64 bf16": (lambda p: K.up_mrf_stage(u5.bfloat16(), up5, b5, 4, 2, 1, br3, KS, DIL,
                                                  packed=p[2]),
                         K.up_mrf_stage_plain(u5.bfloat16(), up5, b5, 2, 1, br3, KS, DIL, K.BF16)),
        "128->64 hifi": (lambda p: K.up_mrf_stage(u5, up5, b5, 4, 2, 1, br3, KS, DIL, hifi=True,
                                                  packed=p[2]),
                         K.up_mrf_stage_plain(u5, up5, b5, 2, 1, br3, KS, DIL, K.F32)),
    }
    variants: dict[str, int | None] = dict(VARIANTS)
    src_dirs = {}
    if other is not None:  # the other checkout's sources as they are
        variants["other"] = None
        src_dirs["other"] = Path(other) / "smart_vocoder_torch" / "kernels" / "csrc"
    libs = build_variants(variants, src_dirs)
    if other is not None:
        ab = _build.BUILD_DIR / "ab"
        compare_sass(ab / "tree.so", ab / "other.so")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"MMA bodies at T = {t}  [{card}]", flush=True)
    times: dict[str, dict[str, list[float]]] = {name: {label: [] for label in cases} for name in libs}
    real_load, real_c = K.load_library, K.WGMMA_CHANNELS
    try:
        legs = list(libs.items())
        for r in range(rounds):  # each round in the other order
            for name, lib in (legs if r % 2 == 0 else legs[::-1]):
                K.load_library = lambda lib=lib: lib
                # the tile layout the build reads
                K.WGMMA_CHANNELS = VARIANTS.get(name, real_c)
                packed = (K.pack_mrf_stage(br3, dev),
                          K.pack_up_mrf_stage(up4, b4, 2, 1, br4, post, dev),
                          K.pack_up_mrf_stage(up5, b5, 2, 1, br3, None, dev))
                row = []
                for label, (call, want) in cases.items():
                    err = (call(packed).float() - want.float()).abs().max().item()
                    times[name][label].append(device_ms(lambda: call(packed)))
                    row.append(f"{label} {times[name][label][-1]:.3f} ms (err {err:.1e})")
                print(f"{name:9s} " + " | ".join(row), flush=True)
    finally:
        K.load_library, K.WGMMA_CHANNELS = real_load, real_c
    results = {name: {label: statistics.median(v) for label, v in per.items()}
               for name, per in times.items()}
    for name, per in times.items():
        print(f"{name:9s} median (min-max) of {rounds}: " + " | ".join(
            f"{label} {results[name][label]:.3f} ({min(v):.3f}-{max(v):.3f})"
            for label, v in per.items()), flush=True)
    return results


if __name__ == "__main__":
    main(*map(int, sys.argv[1:2]), *sys.argv[2:3], *map(int, sys.argv[3:4]))

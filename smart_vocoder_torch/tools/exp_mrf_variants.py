"""Same-process A/B of the packed-MRF stage's variants.

Counterpart of ``scripts/exp_mrf_variants.py``, whose variants each remove one
suspected cost of the TPU kernel. Read for the functions they compute, against
``mrf_stage`` in BF16 mode:

  base, leaky2, nopad : the same function (``max(x,0)+0.1*min(x,0)`` and
      ``max(x,0.1x)`` round alike in bf16; ``nopad`` is wrong only in the halo
      that is thrown away). They differ in TPU vector work only, so one kernel
      computes them: ``mrf_stage(x, ...)``.
  nomask, all : no zeroing outside [0, T) after each conv:
      ``mrf_stage(mask_edges=False)``.
  f32acc : f32 chain state, bf16 conv operands, bf16 output:
      ``mrf_stage(f32_storage=True, out_dtype=torch.bfloat16)``.
  all_f32 : both options.

So four variants are timed (``base``, ``nomask``, ``f32acc``, ``all_f32``) at
the serving shape of the chosen stage, B = 32, bf16, and for the other three
the tool prints which of those computes their function. Beside each time
stands the checksum of the output and of its central rows (more than one stage
radius from both ends), where variants that differ only at the edges agree.
It runs on the CUDA card; ``main(device="cpu")`` runs the plain version at
whatever small size the caller passes.

Usage: python -m smart_vocoder_torch.tools.exp_mrf_variants [stage] [iters] [variant ...]
"""

from __future__ import annotations

import sys

import torch

from smart_vocoder_torch.kernels import LAUNCHES, mrf_stage
from smart_vocoder_torch.kernels.mrf import DILATIONS, pack_mrf_stage, stage_radius
from smart_vocoder_torch.tools import time_ms
from smart_vocoder_torch.utils.device import resolve_device

SHAPES = {1: (8000, 256), 2: (64000, 128), 3: (128000, 64), 4: (256000, 32)}
KS = (3, 7, 11)
B = 32
SEED = 0

VARIANTS = {
    "base": {},
    "nomask": {"mask_edges": False},
    "f32acc": {"f32_storage": True, "out_dtype": torch.bfloat16},
    "all_f32": {"mask_edges": False, "f32_storage": True, "out_dtype": torch.bfloat16},
}
SAME_FUNCTION = {"leaky2": "base", "nopad": "base", "all": "nomask"}


def main(stage: int = 3, iters: int = 10, names=None, device=None, batch: int = B,
         length: int | None = None) -> dict[str, dict]:
    dev = resolve_device(device)
    t, c = SHAPES[stage]
    t = length or t
    names = list(names or list(VARIANTS) + list(SAME_FUNCTION))
    unknown = [n for n in names if n not in VARIANTS and n not in SAME_FUNCTION]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: {list(VARIANTS) + list(SAME_FUNCTION)}")
    gen = torch.Generator(dev).manual_seed(SEED)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).bfloat16()

    branches = [tuple(normal(s, 0.05) for s in ((3, k, c, c), (3, c), (3, k, c, c), (3, c)))
                for k in KS]
    x = normal((batch, t, c), 0.3)
    packed = pack_mrf_stage(branches, dev)  # once, as a serving path holds them
    radius = stage_radius(KS, DILATIONS)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"stage{stage} ({t}x{c}) B={batch} bf16 on {where}, {iters} iterations", flush=True)
    results = {}
    for name in names:
        if name in SAME_FUNCTION:
            print(f"{name:8s}: the function of {SAME_FUNCTION[name]!r}, computed by its kernel")
            continue
        kw = VARIANTS[name]
        before = sum(LAUNCHES.values())
        out = mrf_stage(x, branches, KS, DILATIONS, packed=packed, **kw)
        ms = time_ms(lambda: mrf_stage(x, branches, KS, DILATIONS, packed=packed, **kw), iters,
                     dev)
        results[name] = {"ms": ms, "chk": out.float().sum().item(),
                         "chk_central": out[:, radius:t - radius].float().sum().item(),
                         "launches": sum(LAUNCHES.values()) - before}
        print(f"{name:8s}: {ms:8.2f} ms  (chk {results[name]['chk']:.1f}, "
              f"central {results[name]['chk_central']:.1f})", flush=True)
    return results


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(*map(int, argv[:2]), names=argv[2:] or None)

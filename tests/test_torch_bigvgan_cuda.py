"""BigVGAN-v2's fused anti-aliased SnakeBeta kernel and its route, on the card.

Every test needs an NVIDIA card with ``nvcc`` and skips elsewhere. The file
imports no JAX:

    python -m pytest tests/test_torch_bigvgan_cuda.py -m cuda --noconftest -q

The kernel (``csrc/aa_snake.cu``) against its plain version (torch's chain in
f32, TF32 off) at the stage shapes of BigVGAN-v2 (768 ... 24 channels), at a
length that is a multiple of the kernel's 1024-sample tile and at one that is
not, reading f32 (the residual stream) and bf16 (a conv's output): its bf16
output within one bf16 rounding of the plain f32 result, since the two may
round a value near a tie apart (f32 summation order, and a sine of the
argument reduced by pi as the plain version's ``sin`` reduces it), with slack
near zero of 2e-5 of the largest value. One call of the route at the
published widths and the cell's shapes (32 rows of 345-1000 frames, the 1024
bucket) launches the kernel 109 times and stays within the cell's limit
(``vocbench/traffic/batch_bigvgan.json``) of the plain reference.
"""

import json
import os

import numpy as np
import pytest
import torch

from smart_vocoder_torch.config import HParams, validate
from smart_vocoder_torch.inference import Vocoder
from smart_vocoder_torch.kernels import LAUNCHES, amp
from smart_vocoder_torch.models.bigvgan import kaiser_sinc_filter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "vocbench", "configs", "bigvgan_v2_22khz_80band_256x.json")
TRAFFIC = os.path.join(ROOT, "vocbench", "traffic", "batch_bigvgan.json")


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("c", [768, 384, 192, 96, 48, 24])
@pytest.mark.parametrize("t", [2048, 1000 * 2 + 37])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_aa_snake_kernel_matches_plain(c, t, in_dtype):
    g = torch.Generator(device="cuda").manual_seed(c * 7 + t)
    x = (torch.randn((2, c, t), generator=g, device="cuda") * 3).to(in_dtype)
    act = amp.Snake(*amp.snake_coefficients(
        torch.rand(c, generator=g, device="cuda") - 0.5,
        torch.rand(c, generator=g, device="cuda") - 0.5))
    taps = kaiser_sinc_filter().cuda()
    before = dict(LAUNCHES)
    got = amp.aa_snake(x, act, taps)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]} == {"aa_snake": 1}
    want = amp.aa_snake_plain(x, act, taps)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    ulp = want.abs() * 2.0 ** -8 + 2e-5 * want.abs().max()
    assert ((got.float() - want).abs() <= ulp).all()


@pytest.mark.cuda
def test_one_call_at_published_widths():
    from vocbench import compare
    from vocbench import weights as vweights
    from vocbench.reference import bigvgan as ref

    with open(CONFIG) as f:
        cfg = json.load(f)
    with open(TRAFFIC) as f:
        traffic = json.load(f)
    hps = validate(HParams(**{k: cfg[k] for k in ("data", "model", "tpu")}))
    sizes = ref.Sizes.from_config(cfg)
    state = vweights.make(ref.generator_params(sizes), 5, torch.device("cuda"))
    voc = Vocoder(hps, state, device="cuda")
    rng = np.random.default_rng(5)
    lo, hi = traffic["frames"]
    lengths = rng.integers(lo, hi + 1, traffic["batch"])
    lengths[0] = hi
    mel = rng.standard_normal((len(lengths), hi, 80)).astype(np.float32) * 2 - 4
    mel[np.arange(hi)[None] >= lengths[:, None]] = 0
    before = LAUNCHES["aa_snake"]
    got = voc.mel_to_wav(mel, lengths)
    assert LAUNCHES["aa_snake"] - before == 109
    with compare.reference_precision():
        want = ref.batch_call(state, sizes, mel, lengths, torch.device("cuda"))
    assert compare.waveform_gaps(got, want, cfg["data"])["mel_l1"] < traffic["limits"]["mel_l1"]

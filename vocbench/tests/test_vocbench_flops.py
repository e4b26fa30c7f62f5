"""The benchmark's frozen work formulas equal the program's ``utils/flops.py``
on both configurations."""

import json

import pytest

from smart_vocoder_torch.config import HParams, validate
from smart_vocoder_torch.utils import flops as program_flops
from vocbench import flops, run


@pytest.mark.parametrize("name", ["iitp_base", "iitp_base_ms"])
@pytest.mark.parametrize("batch,frames", [(1, 345), (32, 1000), (16, 672)])
def test_frozen_formulas_equal_the_program(name, batch, frames):
    cfg = run.load_json("vocbench", "configs", f"{name}.json")
    hps = validate(HParams(**{k: json.loads(json.dumps(cfg[k]))
                              for k in ("train", "data", "model", "tpu")}))
    assert flops.synthesis_flops(cfg, batch, frames) == program_flops.synthesis_flops(
        hps, batch, frames)
    assert flops.train_step_flops(cfg, batch, frames) == program_flops.train_step_flops(
        hps, batch, frames)
    assert flops.H100_BF16_PEAK == program_flops.H100_BF16_PEAK


def test_mrf_stage_work():
    """252 C^2 T a stage's MRF, as the kernel table counts it, plus stage 4's
    transposed convolution and conv_post."""
    cfg = run.load_json("vocbench", "configs", "iitp_base.json")
    f, b = flops.mrf_late_stages(cfg, 1000.0)
    t3, t4 = 1000 * 128, 1000 * 256
    want = 252 * 64 ** 2 * t3 + 2 * t3 * 4 * 64 * 32 + 252 * 32 ** 2 * t4 + 2 * t4 * 32 * 7
    assert f == want
    assert flops.roofline_seconds(f, b) == f / flops.H100_BF16_PEAK  # bound by operations

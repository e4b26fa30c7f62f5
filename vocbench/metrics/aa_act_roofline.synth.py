"""aa_act_roofline.synth: the roofline time of the anti-aliased SnakeBeta
activations the calls launched (each call's rows on its padded bucket;
``flops_bigvgan.aa_activations``), over the device time of
``aa_snake_kernel`` in the trace; ``None`` where no such kernel ran."""

from vocbench import flops_bigvgan
from vocbench.measure import ok_calls
from vocbench.reference.synthesis import bucket

KERNEL = r"aa_snake_kernel"


def read(record):
    if record.trace is None:
        return None
    kernel_s, n = record.trace.kernel_seconds(KERNEL)
    calls = ok_calls(record)
    if n == 0 or kernel_s <= 0 or not calls:
        return None
    bound = 0.0
    for s in calls:
        frames = s.attrs["frames"]
        fl, by, _ = flops_bigvgan.aa_activations(record.ctx.config, len(frames),
                                                  bucket(max(frames)))
        bound += flops_bigvgan.roofline_seconds(fl, by)
    return 100.0 * bound / kernel_s

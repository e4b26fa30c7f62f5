"""bigvgan.mfu: BigVGAN-v2's model FLOPs on each row's true frames, over the
seconds from the window's start to the last completed call, as a share of
the card's bf16 peak."""

from vocbench import flops_bigvgan
from vocbench.measure import busy_span_seconds, mfu_pct, ok_calls


def read(record):
    calls = ok_calls(record)
    if not calls:
        return None
    cfg = record.ctx.config
    work = sum(flops_bigvgan.generator_flops(cfg, f) for s in calls for f in s.attrs["frames"])
    return mfu_pct(work, busy_span_seconds(record, calls))

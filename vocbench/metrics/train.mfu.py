"""train.mfu: model FLOPs of each stepped batch at its rows' true frames,
over the window's seconds, as a share of the bf16 peak."""

from vocbench import flops
from vocbench.measure import mfu_pct


def read(record):
    cfg = record.ctx.config
    work = sum(flops.train_step_flops(cfg, 1, f) for s in record.named("vb.step")
               for f in s.attrs["frames"])
    return mfu_pct(work, record.t1 - record.t0)

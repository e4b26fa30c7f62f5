"""live.mfu: model FLOPs of synthesis on each decoded window's length (idle
rows not counted), over the window's seconds, as a share of the bf16 peak."""

from vocbench import flops
from vocbench.measure import mfu_pct, steps


def read(record):
    cfg = record.ctx.config
    work = sum(flops.synthesis_flops(cfg, 1, n) for s in steps(record) for n in s.attrs["lengths"])
    return mfu_pct(work, record.t1 - record.t0)

"""train.fwd_idle_ms: the median over ``train.step`` spans of the ms the
device sat idle inside their ``train.forward`` child (the batch's copy, the
draws, the generator forward, the slices and the jigsaw negative)."""

from vocbench import program_spans as ps
from vocbench.measure import median_ms


def read(record):
    phases = [inside[0] for inside in ps.under(ps.spans(record), "train.step", "train.forward")
              if inside]
    idle = ps.idle_seconds(record, phases)
    return median_ms(idle) if idle else None

"""train.d_idle_ms: the median over ``train.step`` spans of the ms the device
sat idle inside their ``train.d_phase`` child (D's forward, its loss,
gradients and optimizer step)."""

from vocbench import program_spans as ps
from vocbench.measure import median_ms


def read(record):
    phases = [inside[0] for inside in ps.under(ps.spans(record), "train.step", "train.d_phase")
              if inside]
    idle = ps.idle_seconds(record, phases)
    return median_ms(idle) if idle else None

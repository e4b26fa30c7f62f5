"""train.g_idle_ms: the median over ``train.step`` spans of the ms the device
sat idle inside their ``train.g_phase`` child (the generated slice's mel, D's
forward, G's losses, gradients and optimizer step)."""

from vocbench import program_spans as ps
from vocbench.measure import median_ms


def read(record):
    phases = [inside[0] for inside in ps.under(ps.spans(record), "train.step", "train.g_phase")
              if inside]
    idle = ps.idle_seconds(record, phases)
    return median_ms(idle) if idle else None

"""synth.eps_ms: the median over ``synth.call`` spans of the ms of their
``synth.eps`` child (``Vocoder.batch_eps``: every row's prior noise drawn on
the CPU)."""

from vocbench import program_spans as ps
from vocbench.measure import median_ms


def read(record):
    eps = [sum(s.seconds for s in inside)
           for inside in ps.under(ps.spans(record), "synth.call", "synth.eps") if inside]
    return median_ms(eps)

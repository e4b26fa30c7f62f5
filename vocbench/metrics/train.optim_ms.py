"""train.optim_ms: the median over ``train.step`` spans of the summed ms of
the two ``train.optim`` spans inside them (the optimizer's step and
``zero_grad`` for D and for G)."""

from vocbench import program_spans as ps
from vocbench.measure import median_ms


def read(record):
    return median_ms([sum(s.seconds for s in inside)
                      for inside in ps.under(ps.spans(record), "train.step", "train.optim")
                      if inside])

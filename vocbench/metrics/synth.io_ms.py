"""synth.io_ms: the median over ``synth.call`` spans of the summed ms of
their ``synth.pad`` (bucket padding), ``synth.h2d`` (the copies to the
device) and ``synth.trim`` (the returned rows cut to their lengths)
children."""

from vocbench import program_spans as ps
from vocbench.measure import median_ms

PARTS = ("synth.pad", "synth.h2d", "synth.trim")


def read(record):
    spans = ps.spans(record)
    per_call = zip(*(ps.under(spans, "synth.call", part) for part in PARTS))
    return median_ms([sum(s.seconds for part in parts for s in part)
                      for parts in per_call if any(parts)])

"""train.step_ms: the median interval between the starts of successive step
calls in the window (the host sets the pace; the device's work is
asynchronous)."""

from vocbench.measure import median_ms


def read(record):
    starts = [s.start for s in record.named("vb.step")]
    return median_ms([b - a for a, b in zip(starts, starts[1:])])

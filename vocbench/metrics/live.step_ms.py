"""live.step_ms: the median host ms of the ``step()`` calls that decoded a
window."""

from vocbench.measure import median_ms, steps


def read(record):
    return median_ms([s.end - s.start for s in steps(record)])

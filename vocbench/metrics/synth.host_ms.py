"""synth.host_ms: the median over calls of the call's wall time less the time
the device was busy inside it (bucket padding, ``batch_eps``, copies)."""

from vocbench.measure import median_ms, ok_calls


def read(record):
    if record.trace is None:
        return None
    calls = ok_calls(record)
    return median_ms([(s.end - s.start) - record.trace.busy(s.start, s.end) for s in calls])

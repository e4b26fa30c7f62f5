"""live.host_ms: the median over ``serve.step`` spans (``StreamServer.step``
calls that decoded a window) of the span's wall time less the time the device
was busy inside it: the host's part of a server step."""

from vocbench import program_spans as ps
from vocbench.measure import median_ms


def read(record):
    idle = ps.idle_seconds(record, ps.named(ps.spans(record), "serve.step"))
    return median_ms(idle) if idle else None

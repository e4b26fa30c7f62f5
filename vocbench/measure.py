"""Arithmetic the metric readers share: a driver's spans and counters and the
device trace, turned into numbers. A reader returns ``None`` where the run
has nothing for it to read; a share of a peak or of a roofline is never
made up as 0."""

from __future__ import annotations

import statistics

from vocbench import flops

MRF_KERNELS = r"up_mrf_stage_kernel|(?<!\w)mrf_stage_kernel"


def ok_calls(record) -> list:
    return [s for s in record.named("vb.call") if s.attrs.get("ok")]


def busy_span_seconds(record, spans) -> float:
    """Seconds from the window's start to the end of the last of ``spans``."""
    return max(s.end for s in spans) - record.t0


def steps(record) -> list:
    """The live server's ``step()`` calls that decoded a window."""
    return [s for s in record.named("vb.step") if s.attrs.get("windows")]


def device_idle_pct(record):
    tr = record.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy() / tr.window_s)


def mfu_pct(work_flops: float, seconds: float):
    if seconds <= 0 or work_flops <= 0:
        return None
    return 100.0 * work_flops / seconds / flops.H100_BF16_PEAK


def mrf_roofline_pct(record, launches: list[list[int]]):
    """The stage 3-4 roofline time of each launch's true frames, summed, over
    the device time of the stage kernels in the trace."""
    if record.trace is None:
        return None
    kernel_s, n = record.trace.kernel_seconds(MRF_KERNELS)
    if n == 0 or kernel_s <= 0:
        return None
    bound = 0.0
    for frames in launches:
        f, b = flops.mrf_late_stages(record.ctx.config, float(sum(frames)))
        bound += flops.roofline_seconds(f, b)
    return 100.0 * bound / kernel_s


def median_ms(values):
    return 1e3 * statistics.median(values) if values else None

"""What every cell's run shares: the context a driver gets, the spans and
counters it records around its calls into the program, the measured window
with its optional device trace, and the record the metric readers read.

Times are host seconds on ``time.perf_counter``. A traced window runs under
``torch.profiler`` with the device's activity only (no host-side operator
events, which would slow the host path the cells measure). The device's
timeline is put onto the host clock by two marker operations: after a
synchronize the host reads its clock and enqueues one tiny operation, at the
window's start and again at its end, so the first and the last device
operation of the trace are the markers, and a linear map through the pair
places every device interval on the host clock.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
import time
from typing import Any, Optional

import numpy as np

from vocbench import host


def derived_seed(seed: int, *key: int) -> int:
    """A 63-bit seed for one purpose of a run: the same ``(seed, key)``, the
    same number."""
    words = [int(seed) & (2 ** 64 - 1), int(seed) >> 64] + [int(k) for k in key]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(derived_seed(seed, *key))


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float
    attrs: dict


class Recorder:
    """Spans and counters, kept in memory for the run."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        t0 = time.perf_counter()
        s = Span(name, t0, t0, attrs)
        try:
            yield s
        finally:
            s.end = time.perf_counter()
            self.spans.append(s)

    def add(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]


class Trace:
    """Device intervals of a traced window on the host clock: ``(start, end,
    name)`` sorted by start."""

    def __init__(self, ops: list[tuple[float, float, str]], start: float, end: float):
        self.ops = sorted(ops)
        self.start, self.end = start, end
        self._union = _union([(a, b) for a, b, _ in self.ops])
        self._union_starts = [a for a, _ in self._union]

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy(self, lo: float | None = None, hi: float | None = None) -> float:
        """Seconds in ``[lo, hi]`` in which some operation ran on the device."""
        lo = self.start if lo is None else lo
        hi = self.end if hi is None else hi
        i = max(0, bisect.bisect_right(self._union_starts, lo) - 1)
        total = 0.0
        for a, b in self._union[i:]:
            if a >= hi:
                break
            total += max(0.0, min(b, hi) - max(a, lo))
        return total

    def gaps(self) -> list[tuple[float, float]]:
        """The idle intervals of the window."""
        out, t = [], self.start
        for a, b in self._union:
            if a > t:
                out.append((t, min(a, self.end)))
            t = max(t, b)
        if t < self.end:
            out.append((t, self.end))
        return [(a, b) for a, b in out if b > a]

    def kernel_seconds(self, pattern: str) -> tuple[float, int]:
        """Summed device time and count of the operations whose name matches."""
        rx = re.compile(pattern)
        hits = [b - a for a, b, name in self.ops if rx.search(name)]
        return float(sum(hits)), len(hits)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Window:
    """The measured window of a run. ``start()`` and ``stop()`` bound it;
    with ``trace`` the device is profiled over it. The host's counters are
    read just outside it (``host.snapshot``)."""

    def __init__(self, device, trace: bool):
        self.device = device
        self.trace_on = trace and device.type == "cuda"
        self.t0 = self.t1 = None
        self._prof = None
        self._marks: list[float] = []
        self.trace: Optional[Trace] = None
        self.host: list[dict] = []

    def _mark(self):
        import torch

        torch.cuda.synchronize(self.device)
        self._marks.append(time.perf_counter())
        self._marker.add_(1)

    def start(self) -> float:
        import torch

        if self.trace_on:
            from torch.profiler import ProfilerActivity, profile

            self._marker = torch.zeros(1, device=self.device)
            torch.cuda.synchronize(self.device)
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._mark()
        self.host = [host.snapshot()]
        self.t0 = time.perf_counter()
        return self.t0

    def stop(self) -> float:
        self.t1 = time.perf_counter()
        self.host.append(host.snapshot())
        if self._prof is not None:
            self._mark()
            import torch

            torch.cuda.synchronize(self.device)
            self._prof.__exit__(None, None, None)
            self.trace = self._read_trace()
            self._prof = None
        return self.t1

    def _read_trace(self) -> Trace:
        from torch.autograd import DeviceType

        raw = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            a = e.start_ns()
            raw.append((a, a + e.duration_ns(), e.name()))
        raw.sort()
        if len(raw) < 2:
            raise RuntimeError(f"the device trace holds {len(raw)} operations: no markers")
        (m0, _, _), (m1, _, _) = raw[0], raw[-1]
        h0, h1 = self._marks
        scale = (h1 - h0) / ((m1 - m0) * 1e-9) if m1 > m0 else 1.0
        ops = [(h0 + (a - m0) * 1e-9 * scale, h0 + (b - m0) * 1e-9 * scale, name)
               for a, b, name in raw[1:-1]]
        return Trace(ops, self.t0, self.t1)


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its configuration and traffic, the run's
    arguments, the device, and where to record."""

    cell: dict
    config: dict          # the configuration file as JSON
    hps: Any              # the program's HParams of it
    traffic: dict         # the traffic file as JSON
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_process: float      # perf_counter at process start
    recorder: Recorder = dataclasses.field(default_factory=Recorder)
    log: Any = print
    windows: list = dataclasses.field(default_factory=list)

    def window(self) -> Window:
        w = Window(self.device, self.trace)
        self.windows.append(w)
        return w


@dataclasses.dataclass
class Check:
    """One number compared, with its limit: within it when ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value) and self.value <= self.limit)


@dataclasses.dataclass
class Record:
    """What a run leaves for the metric readers and the result line."""

    ctx: Context
    setup_s: float
    t0: float
    t1: float
    attempted: int
    failed: int
    checks: list[Check]
    memory_peak_bytes: int
    trace: Optional[Trace] = None
    data: dict = dataclasses.field(default_factory=dict)

    @property
    def spans(self) -> list[Span]:
        return self.ctx.recorder.spans

    @property
    def counters(self) -> dict:
        return self.ctx.recorder.counters

    def named(self, name: str) -> list[Span]:
        return self.ctx.recorder.named(name)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(c.ok for c in self.checks)


class SpanIndex:
    """The innermost benchmark span open at a time: spans sorted by start,
    searched back from the last one that started."""

    def __init__(self, spans: list[Span]):
        self.spans = sorted(spans, key=lambda s: s.start)
        self.starts = [s.start for s in self.spans]

    def label_at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        for s in self.spans[max(0, i - 64): i + 1][::-1]:
            if s.end > t:
                return s.name
        return "between spans"


def breakdown(record: Record, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed by
    the benchmark span open during each."""
    tr = record.trace
    by_op: dict[str, float] = {}
    for a, b, name in tr.ops:
        by_op[name] = by_op.get(name, 0.0) + (b - a)
    gaps: dict[str, float] = {}
    index = SpanIndex(record.spans)
    for a, b in tr.gaps():
        key = index.label_at(0.5 * (a + b))
        gaps[key] = gaps.get(key, 0.0) + (b - a)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]}

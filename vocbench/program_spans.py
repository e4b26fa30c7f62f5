"""The program's own spans for the per-layer metrics that read them.

``smart_vocoder_torch/utils/profiling.py`` records a span at each of the
program's layer boundaries while a ``torch.profiler`` profile runs in the
process: in a traced run (``--trace 1``) that is the measured window, and in
an untraced run never. Each span has a ``name``, ``start`` and ``end`` on
``time.perf_counter`` (the clock ``harness.Window`` puts the device trace
on), an ``id``, the ``parent`` id of the span open on its thread when it
began, its ``thread`` and ``attrs``. A program that records none (one older
than its spans) gives an empty list here, and each reader then returns
``None``.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Optional


@dataclasses.dataclass
class ProgramSpan:
    name: str
    start: float
    end: float
    id: int
    parent: Optional[int]
    thread: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return self.end - self.start


def recorded() -> list:
    """Every span the program kept, or ``[]`` where it keeps none."""
    from smart_vocoder_torch.utils import profiling

    read = getattr(profiling, "recorded", None)
    return list(read()) if read is not None else []


def spans(record) -> list[ProgramSpan]:
    """The program's spans that meet the window ``[record.t0, record.t1]``,
    clipped to it, sorted by start."""
    out = []
    for s in recorded():
        if s.end < record.t0 or s.start > record.t1:
            continue
        out.append(ProgramSpan(s.name, max(s.start, record.t0), min(s.end, record.t1), s.id,
                               s.parent, s.thread, dict(s.attrs)))
    return sorted(out, key=lambda s: s.start)


def named(spans_: list[ProgramSpan], name: str) -> list[ProgramSpan]:
    return [s for s in spans_ if s.name == name]


def under(spans_: list[ProgramSpan], name: str, child: str) -> list[list[ProgramSpan]]:
    """For each span called ``name``, the spans called ``child`` below it at
    any depth, in its thread."""
    by_id = {s.id: s for s in spans_}
    inside: dict[int, list[ProgramSpan]] = {s.id: [] for s in spans_ if s.name == name}
    for s in spans_:
        if s.name != child:
            continue
        p = by_id.get(s.parent)
        while p is not None and p.name != name:
            p = by_id.get(p.parent)
        if p is not None:
            inside[p.id].append(s)
    return [inside[s.id] for s in spans_ if s.name == name]


def idle_seconds(record, spans_: list[ProgramSpan]) -> Optional[list[float]]:
    """Each span's device-idle seconds: the overlap of the trace's idle gaps
    (``record.trace.gaps()``) with the span; ``None`` without a trace."""
    if record.trace is None:
        return None
    gaps = record.trace.gaps()
    starts = [a for a, _ in gaps]
    out = []
    for s in spans_:
        total = 0.0
        for a, b in gaps[max(0, bisect.bisect_right(starts, s.start) - 1):]:
            if a >= s.end:
                break
            total += max(0.0, min(b, s.end) - max(a, s.start))
        out.append(total)
    return out

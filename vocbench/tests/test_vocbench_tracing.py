"""The readers of the program's own spans (``vocbench/program_spans.py`` and
the metrics that use it): on hand-made spans and a hand-made trace, and on
the spans a tiny run of each traffic kind leaves under a CPU profile."""

import pytest
from torch.profiler import ProfilerActivity, profile

from vocbench import harness, program_spans, run
from vocbench.program_spans import ProgramSpan
from vocbench.tests import tiny

SYNTH = ["synth.eps_ms", "synth.io_ms"]
LIVE = ["live.host_ms"]
TRAIN = ["train.fwd_idle_ms", "train.d_idle_ms", "train.g_idle_ms", "train.optim_ms",
         "train.loader_empty_pct"]
DEVICE = {"live.host_ms", "train.fwd_idle_ms", "train.d_idle_ms", "train.g_idle_ms"}


class Spans:
    """Hand-made program spans, each with an id and its parent's."""

    def __init__(self):
        self.spans = []

    def add(self, name, start, end, parent=None, **attrs):
        s = ProgramSpan(name, start, end, len(self.spans), None if parent is None else parent.id,
                        1, attrs)
        self.spans.append(s)
        return s


def record_of(cell, spans, monkeypatch, ops=None, t0=0.0, t1=2.0):
    ctx, _ = tiny.context(cell)
    monkeypatch.setattr(program_spans, "recorded", lambda: list(spans.spans))
    trace = None if ops is None else harness.Trace(ops, t0, t1)
    return harness.Record(ctx, 1.0, t0, t1, 1, 0, [], 0, trace)


def read(name, record):
    return run.load_reader(name)(record)


def test_synth_readers(monkeypatch):
    sp = Spans()
    for k, (a, eps) in enumerate(((0.0, 0.3), (1.0, 0.5), (2.0, 0.2))):
        call = sp.add("synth.call", a, a + 0.9, call=k, rows=2, bucket=64)
        sp.add("synth.pad", a, a + 0.01, call)
        sp.add("synth.eps", a + 0.01, a + 0.01 + eps, call)
        sp.add("synth.h2d", a + 0.4, a + 0.42, call)
        sp.add("synth.trim", a + 0.8, a + 0.83, call)
    sp.add("synth.h2d", 0.5, 0.6)  # a shard's copy on another thread: no call's
    record = record_of("iitp_base.batch", sp, monkeypatch, t1=3.0)
    assert read("synth.eps_ms", record) == pytest.approx(300.0)
    assert read("synth.io_ms", record) == pytest.approx(60.0)
    # the window clips: the third call lies outside [0, 2], the second is cut
    record.t1 = 1.2
    assert read("synth.eps_ms", record) == pytest.approx(1e3 * (0.3 + 0.19) / 2)


def test_live_host_ms(monkeypatch):
    sp = Spans()
    for a in (0.0, 0.5, 1.0):
        sp.add("serve.step", a, a + 0.4, windows=3, max_streams=4, handles=[1, 2, 3])
    ops = [(0.05, 0.4, "k"), (0.5, 0.6, "k"), (0.62, 0.9, "k"), (1.0, 1.4, "k")]
    record = record_of("iitp_base_ms.live", sp, monkeypatch, ops)
    # idle inside the steps: 50, 20, 0 ms
    assert read("live.host_ms", record) == pytest.approx(20.0)
    assert program_spans.idle_seconds(record, program_spans.spans(record)) == pytest.approx(
        [0.05, 0.02, 0.0])


def test_train_readers(monkeypatch):
    sp = Spans()
    ops = []
    for n, a in enumerate((0.0, 1.0)):
        step = sp.add("train.step", a, a + 0.95, step=n, rows=2, frames=32)
        sp.add("train.forward", a, a + 0.3, step)
        d = sp.add("train.d_phase", a + 0.3, a + 0.6, step)
        sp.add("train.optim", a + 0.5, a + 0.55, d, net="d")
        g = sp.add("train.g_phase", a + 0.6, a + 0.94, step)
        sp.add("train.optim", a + 0.85, a + 0.93 - 0.02 * n, g, net="g")
        sp.add("loader.wait", a + 0.95, a + 1.0, empty=n == 0)
        # busy: all of the forward but 0.1, the D phase but 0.2, the G phase but 0.04 s
        ops += [(a + 0.1, a + 0.3, "k"), (a + 0.5, a + 0.6, "k"), (a + 0.6, a + 0.9, "k")]
    sp.add("loader.wait", 1.96, 1.98, empty=False)
    record = record_of("iitp_base.train", sp, monkeypatch, ops)
    assert read("train.fwd_idle_ms", record) == pytest.approx(100.0)
    assert read("train.d_idle_ms", record) == pytest.approx(200.0)
    assert read("train.g_idle_ms", record) == pytest.approx(40.0)
    assert read("train.optim_ms", record) == pytest.approx(1e3 * (0.05 + 0.07))
    assert read("train.loader_empty_pct", record) == pytest.approx(100.0 / 3)


@pytest.mark.parametrize("cell,names", [("iitp_base.batch", SYNTH),
                                        ("iitp_base_ms.live", LIVE),
                                        ("iitp_base.train", TRAIN)])
def test_no_spans_no_number(monkeypatch, cell, names):
    """A program that records no spans (the parent of the change that added
    them), or a run without a device trace, reads nothing; it never raises."""
    empty = record_of(cell, Spans(), monkeypatch, ops=[])
    assert all(read(n, empty) is None for n in names)
    sp = Spans()
    sp.add("serve.step", 0.1, 0.2, windows=1, max_streams=1, handles=[0])
    sp.add("train.step", 0.1, 0.2, step=0, rows=1, frames=1)
    sp.add("train.forward", 0.1, 0.15, sp.spans[-1])
    untraced = record_of(cell, sp, monkeypatch)
    assert all(read(n, untraced) is None for n in names if n in DEVICE)


def test_no_recorder_in_the_program(monkeypatch):
    """A program whose profiling module has no ``recorded`` gives no spans."""
    from smart_vocoder_torch.utils import profiling

    monkeypatch.delattr(profiling, "recorded")
    assert program_spans.recorded() == []


@pytest.mark.parametrize("cell,names", [("iitp_base.batch", SYNTH),
                                        ("iitp_base_ms.live", LIVE),
                                        ("iitp_base.train", TRAIN)])
def test_readers_find_a_real_runs_spans(cell, names):
    """A tiny run of the cell under a CPU profile leaves the spans each reader
    needs; the device readers get an idle trace of the window."""
    ctx, b = tiny.context(cell)
    with profile(activities=[ProfilerActivity.CPU]):
        record, result = run.execute(ctx, b)
    assert result["correct"]
    spans = program_spans.spans(record)
    assert spans and all(record.t0 <= s.start <= s.end <= record.t1 for s in spans)
    record.trace = harness.Trace([], record.t0, record.t1)
    for name in names:
        value = read(name, record)
        assert value is not None and value >= 0, name
    if cell == "iitp_base.train":
        steps = program_spans.named(spans, "train.step")
        waits = program_spans.named(spans, "loader.wait")
        assert len(steps) == len(record.named("vb.step")) == len(waits)
        phases = zip(*(program_spans.under(spans, "train.step", p)
                       for p in ("train.forward", "train.d_phase", "train.g_phase")))
        for step, parts in zip(steps, phases):
            assert [len(p) for p in parts] == [1, 1, 1]
            assert sum(p[0].seconds for p in parts) >= 0.9 * step.seconds

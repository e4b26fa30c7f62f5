"""What steadies the batch cell without changing what it times or checks:
the driver's warm-up calls and the sample it compares, the host's readings,
and the live kernels' roofline, which counts the work the server launches,
not how full the step is."""

import numpy as np
import pytest
import torch

from vocbench import harness, host, run
from vocbench.drivers import batch
from vocbench.reference import synthesis
from vocbench.tests import tiny


def batch_context(pool: int = 4):
    ctx, b = tiny.context("iitp_base.batch")
    ctx.traffic["pool_calls"] = pool
    return ctx, b


def compared_seeds(monkeypatch) -> list:
    """The call seeds the reference is run on, in order."""
    seen = []
    real = synthesis.batch_call

    def spy(*a, **k):
        seen.append(a[5])
        return real(*a, **k)

    monkeypatch.setattr(synthesis, "batch_call", spy)
    return seen


def answer_at_once(monkeypatch, ctx) -> None:
    """A stand-in for the program that answers at once (silence), so the
    window holds many passes over the pool however loaded the machine is."""
    from smart_vocoder_torch.inference import Vocoder

    ctx.seconds = 0.5
    hop = ctx.config["data"]["hop_length"]
    monkeypatch.setattr(Vocoder, "mel_to_wav", lambda self, mel, lengths, **k: [
        np.zeros(int(n) * hop, np.float32) for n in lengths])


def test_batch_warms_up_then_compares_the_longest_row_call(monkeypatch):
    """Three calls before the window; after it, the sample of every
    completed call that ``sample_calls`` draws, the longest-row call first."""
    ctx, b = batch_context()
    answer_at_once(monkeypatch, ctx)
    seeds = compared_seeds(monkeypatch)
    from smart_vocoder_torch.inference import Vocoder

    made = []
    real = Vocoder.mel_to_wav

    def count(self, *a, **k):
        made.append(k["seed"])
        return real(self, *a, **k)

    monkeypatch.setattr(Vocoder, "mel_to_wav", count)
    record, _ = run.execute(ctx, b)
    calls = batch.make_calls(ctx, 80)
    done = [s.attrs["index"] for s in record.named("vb.call")]
    assert len(done) > len(calls)  # the window ran past the pool's first pass
    window_seeds = [batch.call_seed(ctx, i) for i in done]
    assert made[batch.WARMUP_CALLS:] == window_seeds
    assert len(made) == batch.WARMUP_CALLS + len(done)
    picked = batch.sample_calls(ctx, calls, done)
    longest = max(range(len(calls)), key=lambda i: (int(calls[i]["lengths"].max()), -i))
    assert picked[0] == longest and len(picked) == int(ctx.traffic["check_calls"])
    assert seeds == [batch.call_seed(ctx, i) for i in picked]


def live_record(windows: int):
    ctx, _ = tiny.context("iitp_base_ms.live")
    ctx.recorder = harness.Recorder()
    ctx.recorder.spans += [
        harness.Span("vb.step", t, t + 0.4,
                     {"max_streams": 32, "chunk": 384, "windows": windows,
                      "lengths": [192] * windows}) for t in (0.0, 0.5)]
    ops = [(0.1, 0.3, "void up_mrf_stage_kernel<64>"), (0.6, 0.8, "void mrf_stage_kernel<64, 1>")]
    return harness.Record(ctx, 1.0, 0.0, 1.0, 2, 0, [], 0, harness.Trace(ops, 0.0, 1.0))


def test_live_roofline_counts_the_launched_work():
    read = run.load_reader("mrf_roofline.live")
    one, full = read(live_record(1)), read(live_record(32))
    assert one is not None and one > 0
    assert one == pytest.approx(full)
    assert run.load_reader("live.rows_per_step")(live_record(1)) == pytest.approx(100 / 32)


def test_host_line_parses():
    ctx, b = tiny.context("iitp_base.batch")
    threads = host.place({"torch_threads": torch.get_num_threads()})
    record, _ = run.execute(ctx, b)
    lines = run.host_lines(record, threads)
    assert len(lines) == 1
    got = host.parse(lines[0])
    assert got["torch_threads"] == torch.get_num_threads()
    assert got["d_user_s"] >= 0 and got["d_sys_s"] >= 0 and got["maxrss_kb"] > 0
    assert got["rss_kb"] > 0 and got["rss_kb_before"] > 0
    with pytest.raises(ValueError):
        host.parse("vb.call: 3 in the window")

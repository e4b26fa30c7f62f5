"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have, and so does the control: the reference in
float8 put in the program's place. The harness's look for a card is skipped
(the CPU at the tiny sizes); everything else is a run's."""

import numpy as np
import pytest
import torch

import smart_vocoder_torch.training.step as program_step
from smart_vocoder_torch.inference import Vocoder
from smart_vocoder_torch.programs import ServingProgram
from vocbench import control, run
from vocbench.tests import tiny


def alter_one(o: torch.Tensor) -> torch.Tensor:
    """An answer altered where it is produced: row 0 ten percent louder."""
    o = o.clone()
    o[0] *= 1.1
    return o


def half_left_out(o: torch.Tensor, rows: int | None = None) -> torch.Tensor:
    """Half of the batch left out: the second half of its ``rows`` (default:
    all) replaced by the mean of the first half."""
    o = o.clone()
    n = o.shape[0] if rows is None else rows
    h = n // 2
    if h:
        o[h:n] = o[:h].float().mean(dim=0, keepdim=True).to(o.dtype)
    return o


FAULTS = {"altered": alter_one, "half_batch": half_left_out}


def run_cell(cell):
    ctx, b = tiny.context(cell)
    record, result = run.execute(ctx, b)
    return record, result


def test_sound_runs_are_correct():
    for cell in ("iitp_base.batch", "iitp_base_ms.live", "iitp_base.train"):
        record, result = run_cell(cell)
        assert result["correct"], (cell, [(c.name, c.value, c.limit) for c in record.checks])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_batch_fault_is_caught(monkeypatch, fault):
    real = Vocoder._decode_rows

    def broken(self, *a, **k):
        return FAULTS[fault](torch.from_numpy(real(self, *a, **k))).numpy()

    monkeypatch.setattr(Vocoder, "_decode_rows", broken)
    _, result = run_cell("iitp_base.batch")
    assert result["correct"] is False


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_live_fault_is_caught(monkeypatch, fault):
    real = ServingProgram.run

    def broken(self, **inputs):
        out = real(self, **inputs)
        if self.key[0] != "server":
            return out
        ready = int((inputs["lengths"] > 0).sum())  # the rows of ready windows come first
        return alter_one(out) if fault == "altered" else half_left_out(out, ready)

    monkeypatch.setattr(ServingProgram, "run", broken)
    _, result = run_cell("iitp_base_ms.live")
    assert result["correct"] is False


def unchanged_state(step):
    def broken(state, batch, **kw):
        before = [p.detach().clone() for p in state.net_g.parameters()]
        state, metrics = step(state, batch, **kw)
        with torch.no_grad():
            for p, q in zip(state.net_g.parameters(), before):
                p.copy_(q)
        return state, metrics
    return broken


def half_batch(step):
    def broken(state, batch, **kw):
        h = batch.spec.shape[0] // 2
        return step(state, batch._map(lambda v: v[:h]), **kw)
    return broken


@pytest.mark.parametrize("fault", [unchanged_state, half_batch])
def test_train_fault_is_caught(monkeypatch, fault):
    real = program_step.make_train_step
    monkeypatch.setattr(program_step, "make_train_step",
                        lambda *a, **k: fault(real(*a, **k)))
    record, result = run_cell("iitp_base.train")
    assert result["correct"] is False, [(c.name, c.value, c.limit) for c in record.checks]


@pytest.mark.parametrize("cell", ["iitp_base.batch", "iitp_base_ms.live", "iitp_base.train"])
def test_control_is_not_correct(cell):
    """The reference in float8 fails at least one of the cell's numbers."""
    ctx, _ = tiny.context(cell)
    gaps = control.control_gaps(ctx)
    limits = ctx.traffic["limits"]
    assert any(gaps[name] > limit for name, limit in limits.items()), (gaps, limits)
    assert all(np.isfinite(gaps[name]) for name in limits)

"""The plain reference agrees with the port at a tiny size on the CPU: the
noise rules bit for bit, synthesis (a batch call and a live stream) and the
train step, each against the port run in float32. Only this file imports
both."""

import numpy as np
import pytest
import torch

from smart_vocoder_torch.inference import Vocoder
from smart_vocoder_torch.ops.noise import positional_eps
from smart_vocoder_torch.serving import StreamServer
from vocbench import run, weights
from vocbench.drivers import batch, live
from vocbench.harness import derived_seed
from vocbench.reference import graph, noise, synthesis
from vocbench.tests import tiny


def test_noise_rules_are_the_programs():
    ctx, _ = tiny.context("iitp_base.batch")
    sizes = graph.Sizes.from_config(ctx.config)
    state = weights.make(graph.generator_params(sizes), 3, "cpu")
    voc = Vocoder(ctx.hps, state, device="cpu")
    seed = 2 ** 40 + 7
    assert torch.equal(noise.batch_eps(seed, 3, 64, sizes.inter), voc.batch_eps(seed, 3, 64))
    seeds, starts = [seed, -5, 12], [0, 2 ** 33, 96]
    assert torch.equal(noise.positional_eps(seeds, starts, 40, 192),
                       positional_eps(seeds, starts, 40, 192))


@pytest.mark.parametrize("conditioned", [False, True])
def test_batch_call_matches_the_f32_program(conditioned):
    ctx, _ = tiny.context("iitp_base.batch", conditioned=conditioned)
    sizes = graph.Sizes.from_config(ctx.config)
    state = weights.make(graph.generator_params(sizes), 5, "cpu")
    voc = Vocoder(ctx.hps, state, dtype=torch.float32, use_kernels=False, device="cpu")
    call = batch.make_calls(ctx, sizes.n_mels)[0]
    sid = np.arange(len(call["lengths"])) % 5 if conditioned else None
    got = voc.mel_to_wav(call["mel"], call["lengths"], noise_scale=0.667, seed=99, sid=sid)
    want = synthesis.batch_call(state, sizes, call["mel"], call["lengths"], 0.667, 99, "cpu",
                                sid=sid)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5 * np.abs(w).max())


def test_stream_matches_the_f32_server():
    ctx, _ = tiny.context("iitp_base_ms.live")
    sizes = graph.Sizes.from_config(ctx.config)
    state = weights.make(graph.generator_params(sizes), 6, "cpu")
    voc = Vocoder(ctx.hps, state, dtype=torch.float32, use_kernels=False, device="cpu")
    server = StreamServer(voc, max_streams=4, chunk=64, overlap=16)
    arrivals = live.make_arrivals(ctx, 4.0, 1.0, sizes.n_mels, 5)
    pieces = {}
    for a in arrivals:
        h = server.open(seed=a["seed"], sid=a["sid"], noise_scale=0.667)
        server.feed(h, a["mel"])
        server.close(h)
        pieces[h] = []
    while server.pending():
        for h, w in server.step().items():
            pieces[h].append(w)
    want = synthesis.streams(state, sizes, [a["mel"] for a in arrivals],
                             [a["seed"] for a in arrivals], [a["sid"] for a in arrivals],
                             [0.667] * len(arrivals), 64, 16, "cpu")
    for h, w in zip(sorted(pieces), want, strict=True):
        g = np.concatenate(pieces[h])
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5 * np.abs(w).max())


def test_train_steps_match_the_f32_program():
    """Three steps of the program's loop in float32 against the reference's:
    losses, first gradients and changes within float32 rounding."""
    ctx, b = tiny.context("iitp_base.train", f32=True)
    names = ("loss_rel", "grad_g", "grad_d", "change_g", "change_d")
    ctx.traffic["limits"] = dict.fromkeys(names, 1.0)  # every number, to read them
    record, _ = run.execute(ctx, b)
    assert record.failed == 0
    gaps = {c.name: c.value for c in record.checks}
    assert set(gaps) == set(names)
    assert gaps["loss_rel"] < 1e-4, gaps
    assert max(gaps["grad_g"], gaps["grad_d"]) < 1e-3, gaps
    assert max(gaps["change_g"], gaps["change_d"]) < 1e-2, gaps


def test_weights_are_the_seed_and_the_rule():
    sizes = graph.Sizes.from_config(tiny.CONFIG)
    params = graph.generator_params(sizes)
    a = weights.make(params, derived_seed(1, 0), "cpu")
    b = weights.make(params, derived_seed(1, 0), "cpu")
    c = weights.make(params, derived_seed(2, 0), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["dec.conv_pre.weight"], c["dec.conv_pre.weight"])
    for q in params:
        if q.kind != "embedding" and q.name != "dec.conv_post.weight":
            assert a[q.name].abs().max() <= 1 / np.sqrt(q.fan_in)

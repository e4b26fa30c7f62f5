"""The port's serving programs (``programs.ServingProgram``): windows and the
server's batch through their programs against ``Vocoder._infer`` called
eagerly on the same inputs.

On the CPU a program runs its function on its static buffers instead of
replaying a CUDA graph, so these tests hold what the graph does not change:
which inputs reach the function, the key a program is made under, the launch
tally, what raises. Every comparison is bit for bit: the program calls the
same function on the same values (a float noise scale and the f32 tensor of
it round alike, ``ops.noise.prior_sample``). The capture and the replay are
held on the card (``tests/test_torch_cuda.py``); windows and the server
against the JAX package in ``test_torch_streaming.py`` and
``test_torch_serving.py``, which now go through the programs.
"""

import numpy as np
import pytest
import torch

from smart_vocoder_torch.inference import Vocoder
from smart_vocoder_torch.kernels._build import LAUNCHES, count_launches, reset_launch_counts
from smart_vocoder_torch.models import build_synthesizer
from smart_vocoder_torch.ops import positional_eps
from smart_vocoder_torch.programs import ServingProgram
from smart_vocoder_torch.serving import StreamServer
from smart_vocoder_torch.utils.init import init_synthesizer
from test_torch_package import TINY_CFG, tiny_hparams
from test_torch_streaming import one_thread, port_vocoder  # noqa: F401 (fixture)


def _mel(seed, t, n_mels=80):
    return (np.random.default_rng(seed).normal(size=(t, n_mels)) * 2 - 4).astype(np.float32)


def kernel_vocoder():
    """The kernel route (ResBlock1, ``use_pallas``) in bf16 at hifi 2, whose
    wrappers run their plain versions on the CPU."""
    _, thps = tiny_hparams(TINY_CFG)
    state = init_synthesizer(build_synthesizer(thps), 3).state_dict()
    return Vocoder(thps, state, dtype=torch.bfloat16, buckets=(32,), device="cpu")


def eager_window(voc, mel, lo, chunk, noise_scale, sid, seed):
    """The window through ``_infer`` called eagerly, as before the programs."""
    n = len(mel)
    mel_t = torch.from_numpy(np.pad(mel, ((0, chunk - n), (0, 0))))[None]
    eps = positional_eps([seed], [lo], chunk, int(voc.hps.model.inter_channels))
    o = voc._infer(mel_t, torch.tensor([n]), eps, noise_scale,
                   None if sid is None else torch.tensor([sid]))
    return o[0, : n * voc.hps.data.hop_length, 0].float().numpy()


@pytest.mark.parametrize("route,chunk,sid", [("module_graph", 64, None), ("module_graph", 48, 2),
                                             ("kernels", 32, None)])
def test_window_program_equals_eager_infer(route, chunk, sid):
    """A window through its program is bit-equal to ``_infer`` on the same
    mel, positional noise, noise scale and speaker: two chunks, a
    conditioned config, and the bf16 hifi-2 kernel route."""
    voc = kernel_vocoder() if route == "kernels" else port_vocoder(ms=sid is not None)
    mel = _mel(1, chunk - 5)
    got = voc._synth_window(mel, 17, chunk, 0.8, None if sid is None else np.array([sid]), 9)
    np.testing.assert_array_equal(got, eager_window(voc, mel, 17, chunk, 0.8, sid, 9))


def test_successive_calls_copy_every_input_and_keep_their_results():
    """Two windows in a row through one program, with different mels,
    lengths, seeds, starts and speakers: each equals its eager decode (an
    input left uncopied would repeat the first); the first result, held
    across the second call, does not change."""
    voc = port_vocoder(ms=True)
    a, b = _mel(2, 64), _mel(3, 40)
    program, inputs, _ = voc._window_call(a, 5, 64, 0.667, np.array([1]), 4)
    first = program.run(**inputs)
    held = first.clone()
    got_b = voc._synth_window(b, 300, 64, 0.667, np.array([3]), 8)
    assert len(voc._programs) == 1
    assert torch.equal(first, held)
    np.testing.assert_array_equal(first[0, :, 0].numpy(),
                                  eager_window(voc, a, 5, 64, 0.667, 1, 4))
    np.testing.assert_array_equal(got_b, eager_window(voc, b, 300, 64, 0.667, 3, 8))


def test_one_program_per_chunk_noise_scale_and_conditioning():
    """The key is ``(chunk, noise_scale, conditioned)``: the same key reuses
    its program, a new noise scale or a speaker makes another; ``warmup``
    makes each chunk's at 0.667; ``close`` drops them."""
    voc = port_vocoder(ms=True)
    mel = _mel(4, 30)
    voc._synth_window(mel, 0, 32, 0.667, None, 1)
    first = voc._programs[("window", 32, 0.667, False)]
    voc._synth_window(mel, 9, 32, 0.667, None, 2)
    assert voc._programs[("window", 32, 0.667, False)] is first and len(voc._programs) == 1
    voc._synth_window(mel, 0, 32, 0.5, None, 1)
    voc._synth_window(mel, 0, 32, 0.5, np.array([2]), 1)
    voc.warmup((32, 48))
    assert sorted(voc._programs) == [("window", 32, 0.5, False), ("window", 32, 0.5, True),
                                     ("window", 32, 0.667, False),
                                     ("window", 48, 0.667, False)]
    voc.close()
    assert not voc._programs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_server_program_equals_eager_infer(dtype):
    """A 4-row server's program on rows with mixed seeds, starts, noise
    scales and speakers and an idle row: every row bit-equal to ``_infer``
    called eagerly on the same batch."""
    voc = port_vocoder(ms=True, dtype=dtype)
    server = StreamServer(voc, max_streams=4, chunk=64, overlap=16)
    for i, (ns, sid, t) in enumerate(((0.667, 1, 90), (1.0, 3, 50), (0.3, 0, 200))):
        h = server.open(seed=10 + i, sid=sid, noise_scale=ns)
        server.feed(h, _mel(5 + i, t))
    server.step()  # the next windows start past frame 0
    ready = [(h, s) for h, s in server._streams.items() if s.ready(32, 16)]
    assert len(ready) == 2
    got = server._decode_batch(ready)
    inputs, spans = server._batch(ready)
    assert inputs["lengths"][-1] == 0 and inputs["starts"][0] > 0  # an idle row
    eps = positional_eps(torch.from_numpy(inputs["seeds"]), torch.from_numpy(inputs["starts"]),
                         64, 32)
    want = voc._infer(torch.from_numpy(inputs["mel"]), torch.from_numpy(inputs["lengths"]), eps,
                      torch.from_numpy(inputs["noise_scale"]),
                      torch.from_numpy(inputs["sid"])).float().numpy()
    for r, ((lo, hi, wav), span) in enumerate(zip(got, spans)):
        assert (lo, hi) == span
        np.testing.assert_array_equal(wav, want[r, : (hi - lo) * server.hop, 0])
    assert [k[0] for k in voc._programs] == ["server"]


def test_launch_tally_is_what_the_capture_counted():
    """A stand-in function that counts launches: its capture (on the CPU one
    call) counts into the program's tally, not into ``LAUNCHES``; a run calls
    the function, which counts itself. (A replay adds the tally instead,
    which only the card can show: ``test_torch_cuda.py``.)"""
    def fn(x):
        count_launches("mrf_stage")
        count_launches("wn_stack", 12)
        return x * 2

    reset_launch_counts()
    program = ServingProgram("stand-in", fn, {"x": torch.zeros(3)})
    assert program.tally == {"mrf_stage": 1, "wn_stack": 12}
    assert not any(LAUNCHES.values())
    out = program.run(x=np.arange(3.0))
    assert torch.equal(out, torch.tensor([0.0, 2.0, 4.0]))
    assert {k: v for k, v in LAUNCHES.items() if v} == {"mrf_stage": 1, "wn_stack": 12}
    reset_launch_counts()


def test_what_raises(monkeypatch):
    """Inputs other than the static buffers' names or shapes raise; a
    function that fails at its capture raises with the program's key in the
    exception's notes, and leaves no program behind."""
    program = ServingProgram("k", lambda x: x + 1, {"x": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="inputs"):
        program.run(y=np.zeros((2, 3)))
    with pytest.raises(ValueError, match="shape"):
        program.run(x=np.zeros((3, 2)))
    voc = port_vocoder()

    def failing(*args):
        raise FloatingPointError("the decode failed")

    monkeypatch.setattr(voc, "_infer", failing)
    with pytest.raises(FloatingPointError) as info:
        voc._synth_window(_mel(6, 20), 0, 32, 0.667, None, 1)
    assert info.value.__notes__ == ["serving program ('window', 32, 0.667, False): capture failed"]
    assert not voc._programs

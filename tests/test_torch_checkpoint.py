"""The port's checkpoints (``utils/checkpoint.py``, ``utils/torch_compat.py``)
on the CPU, with the JAX package's ``.pth`` readers and writers as the other
side.

- save -> restore gives back, bit for bit, G, D under spectral norm (its
  ``weight_orig`` and ``weight_u``), both AdamW states, the step and the
  epoch; the pair is written whole, older pairs pruned to ``keep``.
- No checkpoint is a silent fresh start; a truncated latest ``.pth`` logs a
  WARNING and starts fresh, leaving the state as it was.
- A port ``G_*.pth`` loads through JAX's ``load_reference_generator`` into
  JAX's parameter tree, equal to the port's state dict; a ``G_``/``D_`` pair
  written by JAX's ``save_torch_checkpoint`` loads strictly into the port.
"""

import copy
import logging
import os

import jax
import numpy as np
import pytest
import torch

from smart_vocoder_torch.models import build_discriminator
from smart_vocoder_torch.models import build_synthesizer as torch_build
from smart_vocoder_torch.training import init_train_state, make_train_step
from smart_vocoder_torch.utils.checkpoint import CheckpointManager, try_resume
from smart_vocoder_torch.utils.torch_compat import (
    load_reference_discriminator,
    load_reference_generator,
    state_dict_from_jax_params,
)
from smart_vocoder_tpu.utils.checkpoint import load_reference_generator as jax_load_generator
from smart_vocoder_tpu.utils.torch_compat import save_torch_checkpoint as jax_save_checkpoint
from test_torch_streaming import one_thread  # noqa: F401 (fixture)
from test_torch_train_step import batches, jax_state, train_hparams

pytestmark = pytest.mark.usefixtures("one_thread")


def trained_state(spectral_norm=True, steps=2):
    """The tiny config's state after ``steps`` steps (AdamW moments filled,
    ``weight_u`` moved), seeded."""
    _, thps = train_hparams(spectral_norm=spectral_norm)
    jhps, _ = train_hparams(spectral_norm=spectral_norm)
    _, batch = batches(jhps)
    state = init_train_state(thps, seed=3, device="cpu")
    step = make_train_step(thps, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(steps):
        state, _ = step(state, batch, gen)
    return thps, state


def snapshot(state):
    return (copy.deepcopy(state.net_g.state_dict()), copy.deepcopy(state.net_d.state_dict()),
            copy.deepcopy(state.opt_g.state_dict()), copy.deepcopy(state.opt_d.state_dict()),
            state.step)


def assert_equal_trees(a, b):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_equal_trees(x, y)
    else:
        assert a == b


def test_save_restore_bit_exact(tmp_path):
    thps, state = trained_state(spectral_norm=True)
    assert any(k.endswith("weight_u") for k in state.net_d.state_dict())
    assert any(k.endswith("weight_orig") for k in state.net_d.state_dict())
    saved = snapshot(state)
    mngr = CheckpointManager(str(tmp_path), keep=2)
    mngr.save(7, state, epoch=3, learning_rate=1.5e-4)
    assert mngr.latest_step() == 7
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]

    fresh = init_train_state(thps, seed=99, device="cpu")
    fresh, epoch, resumed = try_resume(CheckpointManager(str(tmp_path), keep=2), fresh)
    assert resumed and epoch == 3
    assert_equal_trees(snapshot(fresh), saved)
    assert fresh.step == 2
    # the restored optimizer goes on as the saved one would
    _, batch = batches(train_hparams(spectral_norm=True)[0])
    step = make_train_step(thps, device="cpu")
    a, _ = step(state, batch, torch.Generator().manual_seed(5))
    b, _ = step(fresh, batch, torch.Generator().manual_seed(5))
    assert_equal_trees(snapshot(a), snapshot(b))


def test_keep_prunes(tmp_path):
    _, state = trained_state(spectral_norm=False, steps=1)
    mngr = CheckpointManager(str(tmp_path), keep=2)
    for s in (0, 5, 10, 15):
        mngr.save(s, state, epoch=1, learning_rate=2e-4)
    assert mngr.steps() == [10, 15]
    assert sorted(os.listdir(tmp_path)) == ["D_10.pth", "D_15.pth", "G_10.pth", "G_15.pth"]
    everything = CheckpointManager(str(tmp_path), keep=0)
    everything.save(20, state, epoch=1, learning_rate=2e-4)
    assert everything.steps() == [10, 15, 20]


def test_fresh_start_and_truncated_latest(tmp_path, caplog):
    thps, state = trained_state(spectral_norm=False, steps=1)
    fresh = init_train_state(thps, seed=11, device="cpu")
    before = snapshot(fresh)
    mngr = CheckpointManager(str(tmp_path / "empty"), keep=2)
    with caplog.at_level(logging.WARNING):
        out, epoch, resumed = try_resume(mngr, fresh)
    assert (epoch, resumed) == (1, False) and not caplog.records

    mngr = CheckpointManager(str(tmp_path / "run"), keep=2)
    mngr.save(3, state, epoch=1, learning_rate=2e-4)
    mngr.save(6, state, epoch=1, learning_rate=2e-4)
    path = mngr.path("D", 6)
    with open(path, "rb") as f:
        head = f.read(os.path.getsize(path) // 2)
    with open(path, "wb") as f:
        f.write(head)
    with caplog.at_level(logging.WARNING, logger="smart_vocoder_torch"):
        out, epoch, resumed = try_resume(mngr, fresh)
    assert (epoch, resumed) == (1, False)
    assert any(r.levelno == logging.WARNING and "resume failed" in r.getMessage()
               for r in caplog.records)
    assert_equal_trees(snapshot(out), before)  # nothing half-restored


def test_port_pth_loads_into_jax(tmp_path):
    jhps, thps = train_hparams()
    jb, _ = batches(jhps)
    template = jax_state(jhps, jb, jax_init=False).params_g
    _, state = trained_state(spectral_norm=False, steps=1)
    CheckpointManager(str(tmp_path), keep=1).save(4, state, epoch=2, learning_rate=2e-4)
    params, iteration = jax_load_generator(str(tmp_path / "G_4.pth"), template)
    assert iteration == state.step
    got = state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    want = state.net_g.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_jax_pth_pair_loads_into_port(tmp_path):
    jhps, thps = train_hparams()
    jb, _ = batches(jhps)
    js = jax_state(jhps, jb, jax_init=False)
    g_path, d_path = str(tmp_path / "G_9.pth"), str(tmp_path / "D_9.pth")
    jax_save_checkpoint(g_path, jax.device_get(js.params_g), iteration=9, learning_rate=1e-4)
    jax_save_checkpoint(d_path, jax.device_get(js.params_d), iteration=9, learning_rate=1e-4)
    net_g, net_d = torch_build(thps), build_discriminator(thps)
    assert load_reference_generator(g_path, net_g) == 9
    assert load_reference_discriminator(d_path, net_d) == 9
    want_g = state_dict_from_jax_params(jax.tree.map(np.asarray, js.params_g))
    want_d = state_dict_from_jax_params(jax.tree.map(np.asarray, js.params_d))
    for net, want in ((net_g, want_g), (net_d, want_d)):
        sd = net.state_dict()
        assert set(sd) == set(want)
        for k in want:
            assert torch.equal(sd[k], want[k]), k

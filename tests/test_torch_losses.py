"""The port's losses, segment slicing, NDA jigsaw and optimizer against the
JAX package's, each on its own.

- The five losses on seeded inputs, given in f32 and in bf16: each computes
  in f32 on both sides and agrees within rtol 1e-6.
- Slicing: the JAX package's starts from a key's ``u`` equal the port's from
  the same ``u``, and so do the windows; a start past the end or below 0 is
  placed as ``dynamic_slice`` places it; the port's own draw follows the
  formula.
- ``nda_jigsaw`` against the JAX step's ``_nda_jigsaw`` for a key's
  permutation, and for a key whose permutation is the identity (the fallback
  to ``y_hat``).
- ``lr_for_epoch`` and AdamW against ``optax.adamw`` on identical gradients
  for 3 steps, the learning rate changed before the third, rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_vocoder_torch import losses as tl
from smart_vocoder_torch.ops import rand_slice_segments, slice_segments
from smart_vocoder_torch.training import (
    lr_for_epoch,
    make_optimizer,
    nda_jigsaw,
    set_learning_rate,
)
from smart_vocoder_tpu import losses as jl
from smart_vocoder_tpu.ops import rand_slice_segments as jax_rand_slice
from smart_vocoder_tpu.training import lr_for_epoch as jax_lr_for_epoch
from smart_vocoder_tpu.training import make_optimizer as jax_make_optimizer
from smart_vocoder_tpu.training import set_learning_rate as jax_set_learning_rate
from smart_vocoder_tpu.training.step import _nda_jigsaw
from test_torch_package import tiny_hparams


def _pair(a, dtype):
    """numpy f32 -> (jax array, torch tensor) of the same values in ``dtype``."""
    t = torch.from_numpy(a).to(dtype)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                  else jnp.float32), t


def _close(got, want, rtol=1e-6):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_losses_match_jax(dtype):
    rng = np.random.default_rng(0)
    shapes = [(2, 37), (2, 60), (2, 11)]
    d_r = [_pair(rng.normal(0.5, 0.4, s).astype(np.float32), dtype) for s in shapes]
    d_g = [_pair(rng.normal(0.1, 0.3, s).astype(np.float32), dtype) for s in shapes]
    want, want_r, want_g = jl.discriminator_loss([a for a, _ in d_r], [a for a, _ in d_g])
    got, got_r, got_g = tl.discriminator_loss([b for _, b in d_r], [b for _, b in d_g])
    _close(got, want)
    for g, w in zip(got_r + got_g, want_r + want_g):
        _close(g, w)

    want, want_each = jl.generator_loss([a for a, _ in d_g])
    got, got_each = tl.generator_loss([b for _, b in d_g])
    _close(got, want)
    for g, w in zip(got_each, want_each):
        _close(g, w)

    fm = [[_pair(rng.normal(0, 1, (2, 7, c)).astype(np.float32), dtype) for c in (4, 8)]
          for _ in range(3)]
    fm_g = [[_pair(rng.normal(0, 1, (2, 7, c)).astype(np.float32), dtype) for c in (4, 8)]
            for _ in range(3)]
    want = jl.feature_loss([[a for a, _ in d] for d in fm], [[a for a, _ in d] for d in fm_g])
    _close(tl.feature_loss([[b for _, b in d] for d in fm], [[b for _, b in d] for d in fm_g]),
           want)

    b, t, h = 2, 19, 6
    z_p, logs_q, m_p, logs_p = (_pair(rng.normal(0, s, (b, t, h)).astype(np.float32), dtype)
                                for s in (1.0, 0.3, 1.0, 0.3))
    mask = (np.arange(t)[None, :, None] < np.array([19, 12])[:, None, None]).astype(np.float32)
    want = jl.kl_loss(z_p[0], logs_q[0], m_p[0], logs_p[0], jnp.asarray(mask))
    _close(tl.kl_loss(z_p[1], logs_q[1], m_p[1], logs_p[1], torch.from_numpy(mask)), want)

    mel, mel_hat = (_pair(rng.normal(-4, 2, (2, 8, 80)).astype(np.float32), dtype)
                    for _ in range(2))
    _close(tl.mel_l1_loss(mel[1], mel_hat[1]), jl.mel_l1_loss(mel[0], mel_hat[0]))


def test_slicing_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (3, 40, 5)).astype(np.float32)
    lengths = np.array([40, 25, 9], np.int32)  # the last row is shorter than the window
    size = 10
    key = jax.random.key(7)
    want_x, want_ids = jax_rand_slice(key, jnp.asarray(x), jnp.asarray(lengths), size)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (3,), dtype=jnp.float32)))
    ids = (u * (torch.from_numpy(lengths) - size + 1).float()).to(torch.int32)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    got_x, got_ids = rand_slice_segments(torch.from_numpy(x), torch.from_numpy(lengths), size,
                                         ids=ids)
    assert got_ids.dtype == torch.int32
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    # a start past T - size is clamped, and a negative one counts from the end,
    # as dynamic_slice places them
    far = np.array([35, -45, -3], np.int32)
    want = jax.vmap(lambda r, s: jax.lax.dynamic_slice_in_dim(r, s, size, axis=0))(
        jnp.asarray(x), jnp.asarray(far))
    np.testing.assert_array_equal(slice_segments(torch.from_numpy(x), torch.from_numpy(far),
                                                 size).numpy(), np.asarray(want))
    # the port's own draw: u from the generator, the same formula
    gen = torch.Generator().manual_seed(3)
    u2 = torch.rand((3,), generator=torch.Generator().manual_seed(3))
    _, ids2 = rand_slice_segments(torch.from_numpy(x), torch.from_numpy(lengths), size, gen)
    np.testing.assert_array_equal(ids2.numpy(),
                                  (u2 * torch.tensor([31.0, 16.0, 0.0])).int().numpy())


def _identity_key():
    for i in range(200):
        key = jax.random.key(i)
        if np.array_equal(np.asarray(jax.random.permutation(key, 4)), np.arange(4)):
            return key
    raise AssertionError("no identity permutation in 200 keys")


@pytest.mark.parametrize("identity", [False, True], ids=["perm", "identity"])
def test_nda_jigsaw_matches_jax(identity):
    rng = np.random.default_rng(2)
    y = rng.normal(0, 0.3, (2, 64, 1)).astype(np.float32)
    y_hat = rng.normal(0, 0.3, (2, 64, 1)).astype(np.float32)
    key = _identity_key() if identity else jax.random.key(5)
    perm = np.asarray(jax.random.permutation(key, 4))
    assert np.array_equal(perm, np.arange(4)) == identity
    want = np.asarray(_nda_jigsaw(key, jnp.asarray(y), jnp.asarray(y_hat)))
    got = nda_jigsaw(torch.from_numpy(y), torch.from_numpy(y_hat), torch.from_numpy(perm))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    if identity:
        np.testing.assert_allclose(got.numpy(), y_hat, rtol=1e-6)


def test_lr_for_epoch_matches_jax():
    jhps, thps = tiny_hparams()
    for epoch in (1, 2, 5, 1000):
        assert lr_for_epoch(thps, epoch) == jax_lr_for_epoch(jhps, epoch)
    assert lr_for_epoch(thps, 2) == pytest.approx(2e-4 * 0.999875)


def test_adamw_matches_optax():
    """3 AdamW steps on the same gradients; lr written before the third."""
    jhps, thps = tiny_hparams()
    rng = np.random.default_rng(3)
    shapes = {"a": (16, 8, 3), "b": (16,), "c": (4, 4)}
    params = {k: rng.normal(0, 0.2, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 10.0 ** -i, s).astype(np.float32) for k, s in shapes.items()}
             for i in range(3)]
    tx = jax_make_optimizer(jhps)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(thps, list(tp.values()))
    assert opt.defaults["weight_decay"] == 0.01 and opt.defaults["betas"] == (0.8, 0.99)
    for step, g in enumerate(grads):
        if step == 2:
            state = jax_set_learning_rate(state, lr_for_epoch(thps, 40))
            set_learning_rate(opt, lr_for_epoch(thps, 40))
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       err_msg=f"step {step} {k}")

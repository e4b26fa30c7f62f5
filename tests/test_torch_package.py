"""The PyTorch port's package boundary and weight bridge.

- ``smart_vocoder_torch`` imports no JAX: checked in a clean subprocess.
- JAX parameter trees cross into the port through
  ``state_dict_from_jax_params`` and load strictly, folded and unfolded.

Also holds the small-config helpers the other ``test_torch_*`` files share.
"""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smart_vocoder_torch.config import HParams as TorchHParams
from smart_vocoder_torch.config import validate as torch_validate
from smart_vocoder_torch.models import build_synthesizer as torch_build
from smart_vocoder_torch.nn import fold_weight_norm as torch_fold
from smart_vocoder_torch.utils.torch_compat import state_dict_from_jax_params
from smart_vocoder_tpu.config import HParams as JaxHParams
from smart_vocoder_tpu.config import validate as jax_validate
from smart_vocoder_tpu.models import build_synthesizer as jax_build
from smart_vocoder_tpu.nn import fold_weight_norm as jax_fold

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A ResBlock1 config cut to test size: 128/64/32 decoder channels, so the JAX
# fast decoder sends its last two stages to the Pallas kernels (stage 1 stays
# on XLA convs) exactly as iitp_base does, and the port routes the same
# stages to its CUDA kernel wrappers.
TINY_CFG = {
    "train": {"log_interval": 1, "eval_interval": 10, "seed": 0, "epochs": 1,
              "learning_rate": 2e-4, "betas": [0.8, 0.99], "eps": 1e-9,
              "batch_size": 1, "fp16_run": False, "lr_decay": 0.999875,
              "segment_size": 256, "c_mel": 45, "c_kl": 1.0},
    "data": {"training_files": "", "validation_files": "", "max_wav_value": 32768.0,
             "sampling_rate": 22050, "filter_length": 1024, "hop_length": 16,
             "win_length": 1024, "n_mel_channels": 80, "mel_fmin": 0.0,
             "mel_fmax": None, "n_speakers": 0},
    "model": {"inter_channels": 16, "hidden_channels": 16, "resblock": "1",
              "resblock_kernel_sizes": [3, 7, 11],
              "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
              "upsample_rates": [4, 2, 2], "upsample_initial_channel": 256,
              "upsample_kernel_sizes": [8, 4, 4], "gin_channels": 0,
              "enc_layers": 2, "flow_wn_layers": 2},
    "tpu": {"use_pallas": True},
}


def tiny_hparams(cfg=None):
    """The same config dict as both packages' HParams."""
    cfg = copy.deepcopy(cfg or TINY_CFG)
    return jax_validate(JaxHParams(**cfg)), torch_validate(TorchHParams(**copy.deepcopy(cfg)))


def random_params(shapes, seed):
    """Fill a JAX parameter-shape tree with seeded numpy values at torch's
    init scale (uniform +-1/sqrt(fan_in)); each ``weight_g`` is its
    ``||weight_v||`` times a factor near 1, so weight norm is exercised.
    Compiling the real flax init of even a tiny synthesizer on the CPU takes
    ~20 s; its tree of shapes (``jax.eval_shape``) takes ~1 s."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = fill(leaf)
                continue
            shape = tuple(leaf.shape)
            bound = 1.0 / np.sqrt(np.prod(shape[1:])) if len(shape) > 1 else 0.1
            out[name] = rng.uniform(-bound, bound, shape).astype(np.float32)
        if "weight_v" in out:
            v = out["weight_v"]
            norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
            out["weight_g"] = (norm * rng.uniform(0.8, 1.2, norm.shape)).astype(np.float32)
        return out

    return fill(shapes)


def jax_synth_params(jhps, seed=1, t=32):
    """Weight-normed params (numpy tree) with the structure of
    ``build_synthesizer(jhps).init`` and seeded values."""
    net = jax_build(jhps)
    mel = jnp.zeros((1, t, jhps.data.n_mel_channels))
    spec = jnp.zeros((1, t, jhps.data.filter_length // 2 + 1))
    lens = jnp.full((1,), t, jnp.int32)
    sid = jnp.zeros((1,), jnp.int32) if jhps.model.get("use_spk_embed", False) else None
    shapes = jax.eval_shape(
        lambda k1, k2: net.init(k1, mel, lens, spec, lens, k2, sid=sid)["params"],
        jax.random.key(0), jax.random.key(1))
    return random_params(shapes, seed)


def test_port_imports_no_jax():
    """Every module of the port, found by walking the package (a new module
    is covered without being listed), imports with no JAX, flax or JAX
    package module loaded."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import smart_vocoder_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "missing = {'smart_vocoder_torch.kernels.mrf', 'smart_vocoder_torch.training.loop',\n"
        "           'smart_vocoder_torch.data.pipeline', 'smart_vocoder_torch.train'} - set(mods)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'orbax', 'smart_vocoder_tpu'))\n"
        "print('MODULES', len(mods), 'NOT WALKED', missing, 'BAD', bad)\n"
        "sys.exit(1 if bad or missing else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("folded", [False, True])
def test_bridge_loads_strictly(folded):
    jhps, thps = tiny_hparams()
    params = jax_synth_params(jhps)
    if folded:
        params = jax.tree.map(np.asarray, jax_fold(params))
    sd = state_dict_from_jax_params(params)
    net = torch_build(thps, weight_norm=not folded)
    missing, unexpected = net.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    assert set(sd) == set(net.state_dict())
    # folding on either side of the bridge gives the same weights
    if folded:
        unfolded = state_dict_from_jax_params(jax_synth_params(jhps))
        ours = torch_fold(unfolded)
        assert set(ours) == set(sd)
        for k in sd:
            np.testing.assert_allclose(ours[k].numpy(), sd[k].numpy(), rtol=1e-6, atol=1e-6)


def test_bridge_speaker_conditioned():
    """A speaker-conditioned model's emb_g / cond_layer / cond keys cross too."""
    cfg = copy.deepcopy(TINY_CFG)
    cfg["data"]["n_speakers"] = 3
    cfg["model"].update(gin_channels=8, use_spk_embed=True)
    jhps, thps = tiny_hparams(cfg)
    sd = state_dict_from_jax_params(jax_synth_params(jhps))
    assert "emb_g.weight" in sd and "dec.cond.weight" in sd
    assert any(".cond_layer." in k for k in sd)
    torch_build(thps).load_state_dict(sd, strict=True)

"""The fidelity weight recipe, rebuilt without JAX.

Counterpart of ``smart_vocoder_tpu/utils/golden.py``: the weights and inputs
behind ``tests/fixtures/golden_iitp_base.npz`` (the torch reference's f32
waveform for one pinned weights, mel and noise triple) and behind the JAX
package's ``bench.py``. There they come from the flax init of the
weight-normed generator under ``jax.random.key(1)``; here from the same
draws in numpy (``utils/jax_random.py``), so the card is held to the same
fixture with no JAX on its machine.

Flax derives a parameter's key from its place alone: ``fold_in(root,
h)``, where ``h`` is the first 4 bytes (big-endian) of the SHA-1 of the
module path's names and the parameter's counter in its module (the n-th
``self.param`` call there), with no separator between the parts. A conv
(``smart_vocoder_tpu/nn/conv.py``) makes ``weight_v`` then ``weight_g`` (or a
plain ``weight``), then ``bias``. The inits are torch's conv default (uniform
+-1/sqrt(fan_in)), ``weight_g = ||weight_v||`` over every dim but 0 (its key
is drawn and unused), a zero ``weight`` for each coupling layer's ``post``
conv, and flax's ``nn.Embed`` default (normal, variance 1/features) for the
speaker table. ``conv_post``'s weight is then scaled by ``CONV_POST_GAIN``,
which lifts a fresh generator's output from near-silence (rms ~0.011) to
speech-like levels, so that mel-L1 measures the implementation and not the
``log(clamp(., 1e-5))`` floor.

Every drawn value equals JAX's bit for bit, the speaker table's within an
ulp (``jax_random.normal``). ``weight_g`` is a sum of squares whose order
XLA's CPU compiler picks per shape, so numpy's sum can sit a few ulps (rel
4e-7) from it, and a folded weight-normed weight likewise.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import numpy as np
import torch

from smart_vocoder_torch.models import build_synthesizer
from smart_vocoder_torch.nn.conv import _WeightNormConv
from smart_vocoder_torch.nn.coupling import ResidualCouplingLayer
from smart_vocoder_torch.utils import jax_random
from smart_vocoder_torch.utils.torch_compat import torch_key_to_path

CONV_POST_GAIN = 30.0  # output rms ~0.011 -> ~0.3, well above the mel floor
INIT_KEYS = (1, 2)     # the params key; the second keys the init's forward only
MEL_KEY = 0
EPS_KEY = 4
NOISE_SCALE = 0.667  # the notebook's synthesis setting (inference.ipynb cell 4)
FRAMES = 200         # fixture length (~2.3 s at hop 256)


def param_key(root: np.ndarray, path: Tuple[str, ...], counter: int) -> np.ndarray:
    """The key flax hands the ``counter``-th parameter of the module at
    ``path`` (its names, the parameter's own left out) under ``root``."""
    digest = hashlib.sha1()
    for name in path:
        digest.update(name.encode("utf-8"))
    digest.update(counter.to_bytes((counter.bit_length() + 7) // 8, "big"))
    return jax_random.fold_in(root, int.from_bytes(digest.digest()[:4], "big"))


def _norm_except_dim0(v: np.ndarray) -> np.ndarray:
    return np.sqrt(np.sum(np.square(v), axis=tuple(range(1, v.ndim)), keepdims=True))


def _conv_params(root, prefix: str, mod: _WeightNormConv, zero: bool) -> Dict[str, np.ndarray]:
    path = torch_key_to_path(prefix)
    bound = 1.0 / math.sqrt(mod.fan_in)
    names = (["weight_v", "weight_g"] if mod.weight_norm else ["weight"])
    names += ["bias"] if mod.bias is not None else []
    out = {}
    for counter, name in enumerate(names, start=1):
        shape = tuple(getattr(mod, name).shape)
        if name == "weight_g":
            out[name] = _norm_except_dim0(out["weight_v"]).reshape(shape)
        elif zero and name != "bias":
            out[name] = np.zeros(shape, np.float32)
        else:
            out[name] = jax_random.uniform(param_key(root, path, counter), shape, -bound, bound)
    return {f"{prefix}.{name}": v for name, v in out.items()}


def fidelity_state_dict(hps, folded: bool = True) -> Dict[str, torch.Tensor]:
    """The JAX package's ``fidelity_params(hps, ..., folded)`` as the port's
    generator state dict (reference keys, f32 tensors on the CPU), every key
    of ``build_synthesizer(hps)`` included: weight-normed ``weight_v`` /
    ``weight_g`` pairs, or with ``folded`` their plain ``weight``."""
    net = build_synthesizer(hps, weight_norm=True, device="meta")
    root = jax_random.key(INIT_KEYS[0])
    zero_post = {id(m.post) for m in net.modules() if isinstance(m, ResidualCouplingLayer)}
    params: Dict[str, np.ndarray] = {}
    for name, mod in net.named_modules():
        if isinstance(mod, _WeightNormConv):
            params.update(_conv_params(root, name, mod, id(mod) in zero_post))
        elif isinstance(mod, torch.nn.Embedding):
            n, features = mod.weight.shape
            std = np.sqrt(np.float32(1.0 / features))
            params[f"{name}.weight"] = jax_random.normal(
                param_key(root, torch_key_to_path(name), 1), (n, features)) * std
    params["dec.conv_post.weight"] = params["dec.conv_post.weight"] * np.float32(CONV_POST_GAIN)
    if folded:
        for key in [k for k in params if k.endswith(".weight_v")]:
            v, g = params.pop(key), params.pop(key[:-1] + "g")
            params[key[:-len("_v")]] = v * (g / _norm_except_dim0(v))
    order = build_synthesizer(hps, weight_norm=not folded, device="meta").state_dict()
    assert set(order) == set(params), sorted(set(order) ^ set(params))
    return {k: torch.from_numpy(params[k]) for k in order}


def fidelity_inputs(hps):
    """The fixture's ``(mel (1, FRAMES, n_mels), lens (1,), eps (1, FRAMES,
    inter_channels))`` as numpy arrays, from the JAX package's keys."""
    mel = jax_random.normal(jax_random.key(MEL_KEY),
                            (1, FRAMES, hps.data.n_mel_channels)) * np.float32(2) - np.float32(4)
    lens = np.full((1,), FRAMES, np.int64)
    eps = jax_random.normal(jax_random.key(EPS_KEY), (1, FRAMES, hps.model.inter_channels))
    return mel, lens, eps

"""Functional prior encoder + reverse flow over the folded state dict.

Counterpart of ``smart_vocoder_tpu/kernels/encoder.py``: the serving-path
alternative to the ``MelEncoder`` / ``ResidualCouplingBlock`` module graph.
The 1x1 projections are plain matmuls, and every unconditioned WN stack (16
``enc_p`` layers + 4 x 8 flow layers, reference modules.py:111-184) runs
through :func:`~smart_vocoder_torch.kernels.wn_stack.wn_stack` (the CUDA
kernel on the card) with ``use_kernel=True``, or through
:func:`~smart_vocoder_torch.kernels.wn_stack.wn_stack_reference` (cuDNN, the
counterpart of ``_wn_stack_xla``) with ``use_kernel=False``.

Tensors are time-major as in the JAX functions: mel ``(B, T, n_mels)``,
``x_mask (B, T, 1)``, latents ``(B, T, inter)``. The state dict is the folded
generator's (``enc_p.pre_enc.weight``, ``enc_p.encoder.in_layers.0.weight``,
``flow.flows.0.pre.weight``, ...). Unconditioned (g=None) only: ``Vocoder``
routes a speaker-conditioned request to the module graph.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

from smart_vocoder_torch.kernels.wn_stack import (
    PackedChunk,
    pack_wn_stack,
    wn_layers_from_state_dict,
    wn_stack,
    wn_stack_reference,
)
from smart_vocoder_torch.ops.noise import prior_sample

PackedStacks = Mapping[str, List[PackedChunk]]  # WN prefix -> its packed chunks


def _matmul_1x1(x: torch.Tensor, w_oik: torch.Tensor, bias: torch.Tensor | None,
                dtype: torch.dtype) -> torch.Tensor:
    """A folded torch-layout (O, I, 1) conv as one matmul on (B, T, I), in
    ``dtype`` (the bias add rounds again in bf16, as XLA's does)."""
    y = x.to(dtype) @ w_oik[:, :, 0].t().to(dtype)
    return y if bias is None else y + bias.to(dtype)


def _wn(state, prefix, x, mask, n_layers, hidden, use_kernel, layers_per_call, packed):
    layers = wn_layers_from_state_dict(state, prefix, n_layers)
    if use_kernel:
        return wn_stack(x, mask, layers, hidden, layers_per_call,
                        packed=None if packed is None else packed[prefix])
    return wn_stack_reference(x, mask, layers, hidden)


def pack_prior_flow(state: Mapping[str, torch.Tensor], enc_layers: int = 16, n_flows: int = 4,
                    flow_wn_layers: int = 8, hidden: int = 192,
                    dtype: torch.dtype = torch.bfloat16, layers_per_call: int = 4,
                    device=None) -> Dict[str, List[PackedChunk]]:
    """Every WN stack of :func:`prior_flow_apply` in the kernel's weight
    layout (``pack_wn_stack``), keyed by prefix: the ``packed`` argument of
    the functions here, made once by a server."""
    stacks = [("enc_p.encoder", enc_layers)] + [(f"flow.flows.{2 * i}.enc", flow_wn_layers)
                                                for i in range(n_flows)]
    return {prefix: pack_wn_stack(wn_layers_from_state_dict(state, prefix, n), hidden, dtype,
                                  layers_per_call, device) for prefix, n in stacks}


def enc_p_apply(state: Mapping[str, torch.Tensor], mel: torch.Tensor, x_mask: torch.Tensor,
                n_layers: int = 16, hidden: int = 192, use_kernel: bool = True,
                dtype: torch.dtype = torch.bfloat16, layers_per_call: int = 4,
                packed: Optional[PackedStacks] = None):
    """Mel prior network: (m_p, logs_p), each (B, T, inter). Mirrors
    MelEncoder (pre 1x1 -> WN(g=None) -> proj 1x1, the mask applied at the
    WN input and at the stats). ``packed``: from :func:`pack_prior_flow`."""
    mask = x_mask.to(dtype)
    x = _matmul_1x1(mel, state["enc_p.pre_enc.weight"], state["enc_p.pre_enc.bias"], dtype)
    x = _wn(state, "enc_p.encoder", x * mask, x_mask, n_layers, hidden, use_kernel,
            layers_per_call, packed)
    stats = _matmul_1x1(x, state["enc_p.proj.weight"], state["enc_p.proj.bias"], dtype) * mask
    out = stats.shape[-1] // 2
    return stats[..., :out], stats[..., out:]


def flow_reverse_apply(state: Mapping[str, torch.Tensor], x: torch.Tensor,
                       x_mask: torch.Tensor, n_flows: int = 4, n_layers: int = 8,
                       hidden: int = 192, use_kernel: bool = True,
                       dtype: torch.dtype = torch.bfloat16, layers_per_call: int = 4,
                       packed: Optional[PackedStacks] = None):
    """Reverse residual-coupling flow z_p -> z (B, T, inter): per step, flip
    the channels, then the mean-only coupling ``x1 = (x1 - m(x0)) * mask``
    (encoder.py:84-101)."""
    mask = x_mask.to(dtype)
    x = x.to(dtype)
    for i in reversed(range(n_flows)):
        x = torch.flip(x, dims=(-1,))  # Flip, its own inverse
        pre = f"flow.flows.{2 * i}"
        half = x.shape[-1] // 2
        x0, x1 = x[..., :half], x[..., half:]
        h = _matmul_1x1(x0, state[f"{pre}.pre.weight"], state[f"{pre}.pre.bias"], dtype) * mask
        h = _wn(state, f"{pre}.enc", h, x_mask, n_layers, hidden, use_kernel, layers_per_call,
                packed)
        m = _matmul_1x1(h, state[f"{pre}.post.weight"], state[f"{pre}.post.bias"], dtype) * mask
        x = torch.cat([x0, (x1 - m) * mask], dim=-1)
    return x


def prior_flow_apply(state: Mapping[str, torch.Tensor], mel: torch.Tensor,
                     x_mask: torch.Tensor, eps: torch.Tensor, noise_scale: float | torch.Tensor,
                     enc_layers: int = 16, n_flows: int = 4, flow_wn_layers: int = 8,
                     hidden: int = 192, use_kernel: bool = True,
                     dtype: torch.dtype = torch.bfloat16,
                     packed: Optional[PackedStacks] = None) -> torch.Tensor:
    """mel -> masked latent z (B, T, inter): ``SynthesizerTrn.infer`` up to
    the decoder, with ``eps (B, T, inter)`` the prior noise. The noise scale,
    a float or one per row ``(B,)``, is rounded to ``dtype`` as JAX rounds a
    Python scalar against a bf16 array (``ops.noise.prior_sample``)."""
    m_p, logs_p = enc_p_apply(state, mel, x_mask, enc_layers, hidden, use_kernel, dtype,
                              packed=packed)
    z_p = prior_sample(m_p, logs_p, eps, noise_scale)
    z = flow_reverse_apply(state, z_p, x_mask, n_flows, flow_wn_layers, hidden, use_kernel,
                           dtype, packed=packed)
    return z * x_mask.to(z.dtype)

"""Inference API: the mel -> wav product path.

Counterpart of ``smart_vocoder_tpu/inference.py:Vocoder``: a weight-norm-folded
``SynthesizerTrn`` with bucketed padding, so arbitrary lengths map onto a
bounded set of shapes. The serving path (``_apply_infer_fast``) runs the prior
and the reverse flow through the module graph, or with ``use_wn_kernels``
through ``kernels/encoder.py:prior_flow_apply`` (every WN stack on the CUDA
WN kernel), and the decoder through ``kernels/decoder.py:decoder_apply``,
whose late stages are the hand-written CUDA kernels; ``_apply_infer`` is the
plain module graph.
"""

from __future__ import annotations

import bisect
import copy
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from smart_vocoder_torch.config import HParams, load_config
from smart_vocoder_torch.kernels.decoder import DecoderConfig, decoder_apply, pack_decoder
from smart_vocoder_torch.kernels.encoder import pack_prior_flow, prior_flow_apply
from smart_vocoder_torch.models import build_synthesizer
from smart_vocoder_torch.nn import fold_weight_norm
from smart_vocoder_torch.ops import MelConfig, sequence_mask, spec_to_mel, spectrogram
from smart_vocoder_torch.utils.device import resolve_device
from smart_vocoder_torch.utils.torch_compat import load_reference_generator


def set_precision_flags() -> None:
    """TF32 off for cuDNN convolutions and matmuls, at every precision level.

    TF32 keeps ~3 decimal digits of an f32 operand. The f32 path is the
    port's oracle and must be real f32. Levels 2-3 emulate the JAX recipe of
    bf16-rounded operands with f32 accumulation on f32 tensors, and level 0's
    bf16 convolutions do not read the flag. So one setting serves all levels.
    (TF32 would be exact on operands that are already bf16 values -- a speed
    option for levels >= 2 that a later change can measure.)"""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class Vocoder:
    """mel (B, T, n_mels) or wav -> waveform synthesis with bucketed shapes."""

    def __init__(self, hps: HParams, state_dict: Mapping[str, torch.Tensor],
                 dtype: torch.dtype = torch.bfloat16,
                 buckets: Sequence[int] = (64, 128, 256, 512, 1024, 2048, 4096),
                 fold: bool = True, use_kernels: bool | None = None,
                 hifi: bool | int | None = None, device: str | torch.device | None = None,
                 use_wn_kernels: bool | None = None):
        """``state_dict``: generator weights (folded or weight-normed), e.g.
        from ``state_dict_from_jax_params`` or a reference ``G_*.pth``.
        ``use_kernels`` defaults to the config's ``tpu.use_pallas``; ``hifi``
        to ``tpu.hifi_tail`` or level 2 (``True`` maps to 2), and applies only
        to the kernel path in bf16. ``device`` defaults to the CUDA card and
        raises where there is none; the CPU only with ``device="cpu"``.
        ``use_wn_kernels`` (the JAX
        ``use_pallas_wn``, default ``tpu.use_pallas_wn``) runs an
        unconditioned request's prior and flow through ``prior_flow_apply``
        in ``dtype`` -- also at hifi >= 2, where the module-graph prior would
        be f32, as the JAX path does (inference.py:211); it needs ``fold``
        and ``hidden_channels % 64 == 0``."""
        set_precision_flags()
        self.hps = hps
        self.device = resolve_device(device)
        self.mel_cfg = MelConfig.from_hparams(hps)
        self.buckets = sorted(buckets)
        if use_kernels is None:
            use_kernels = bool(hps.tpu.get("use_pallas", False))
        self.use_kernels = bool(use_kernels and fold and hps.model.resblock == "1")
        if use_wn_kernels is None:
            use_wn_kernels = bool(hps.tpu.get("use_pallas_wn", False))
        self.use_wn_kernels = bool(use_wn_kernels and fold
                                   and hps.model.hidden_channels % 64 == 0)
        if hifi is None:
            hifi = hps.tpu.get("hifi_tail", True)
        hifi = 2 * int(hifi) if isinstance(hifi, bool) else int(hifi)
        self.hifi = hifi if (self.use_kernels and dtype == torch.bfloat16) else 0
        self.dtype = dtype

        if fold:
            state_dict = fold_weight_norm(state_dict)
        net = build_synthesizer(hps, weight_norm=not fold, device=self.device)
        net.load_state_dict(state_dict, strict=True)
        net.eval()
        # f32 weights; the module graph runs in `dtype` (a bf16 copy), except
        # the prior at hifi >= 2, which runs in f32 (inference.py:91-96).
        self.net = net if dtype == torch.float32 else copy.deepcopy(net).to(dtype)
        self.net_prior = net if self.hifi >= 2 else self.net
        self.params = net.state_dict()  # folded f32 weights of the functional paths
        self.dec_params = {k[len("dec."):]: v for k, v in self.params.items()
                           if k.startswith("dec.")}
        self.dec_cfg = DecoderConfig.from_hparams(hps)
        # the MRF weights as decoder_apply and its kernels read them, made once
        self.dec_packed = (pack_decoder(self.dec_params, self.dec_cfg, dtype, self.hifi)
                           if self.use_kernels else None)
        m = hps.model
        self.wn_sizes = dict(enc_layers=m.get("enc_layers", 16),
                             flow_wn_layers=m.get("flow_wn_layers", 8), hidden=m.hidden_channels)
        # the WN kernel's weight layout, made once rather than per request
        self.wn_packed = (pack_prior_flow(self.params, **self.wn_sizes, dtype=dtype,
                                          device=self.device)
                          if self.use_wn_kernels else None)

    @classmethod
    def from_torch_checkpoint(cls, config_path: str, pth_path: str, **kw) -> "Vocoder":
        """Load a reference ``G_*.pth`` (notebook cell 3); ``device`` as in
        ``__init__`` (the checkpoint itself is read on the CPU)."""
        kw["device"] = resolve_device(kw.get("device"))  # before any file is read
        hps = load_config(config_path)
        net = build_synthesizer(hps)
        load_reference_generator(pth_path, net)
        return cls(hps, net.state_dict(), **kw)

    # -- synthesis -----------------------------------------------------------
    def _bucket(self, t: int) -> int:
        i = bisect.bisect_left(self.buckets, t)
        return self.buckets[i] if i < len(self.buckets) else t

    def batch_eps(self, seed: int, b: int, t: int) -> torch.Tensor:
        """Prior noise (b, t, inter_channels): row i draws from a CPU generator
        seeded from (seed, i), so the noise an utterance sees does not depend
        on the device or on the other rows of its batch."""
        c = int(self.hps.model.inter_channels)
        rows = []
        for i in range(b):
            s = int(np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0])
            rows.append(torch.randn((t, c), generator=torch.Generator().manual_seed(s)))
        return torch.stack(rows)

    @torch.inference_mode()
    def _apply_infer(self, mel, lengths, eps, noise_scale, sid=None):
        o, _ = self.net.infer(mel, lengths, eps, noise_scale, sid)
        return o

    @torch.inference_mode()
    def _apply_infer_fast(self, mel, lengths, eps, noise_scale, sid=None):
        """The prior and flow on the WN kernel (unconditioned requests under
        ``use_wn_kernels``) or the module graph; the decoder through
        ``decoder_apply`` under ``use_kernels``, else the module graph."""
        conditioned = self.net.emb_g is not None and sid is not None
        if self.use_wn_kernels and not conditioned:
            mask = sequence_mask(lengths, mel.shape[1])[..., None].to(self.dtype)
            z = prior_flow_apply(self.params, mel, mask, eps, noise_scale, **self.wn_sizes,
                                 dtype=self.dtype, packed=self.wn_packed)
            g = None
        else:
            z, _, g = self.net_prior.prior_latent(mel, lengths, eps, noise_scale, sid)
            z = z.transpose(1, 2)
        if not self.use_kernels:
            return self.net.dec(z.transpose(1, 2), g=g).transpose(1, 2)
        return decoder_apply(self.dec_params, z, self.dec_cfg,
                             g=None if g is None else g.transpose(1, 2),
                             dtype=self.dtype, hifi_tail=self.hifi, packed=self.dec_packed)

    def mel_to_wav(self, mel: np.ndarray, lengths: Optional[np.ndarray] = None,
                   noise_scale: float = 0.667, sid: Optional[np.ndarray] = None,
                   seed: int = 0, eps: Optional[np.ndarray] = None) -> list[np.ndarray]:
        """mel (B, T, n_mels) -> list of B float32 waveforms (true lengths).

        The batch is padded to the next bucket; ``eps`` (B, T, inter_channels)
        pins the prior noise and is zero-padded like the mel, else it is drawn
        by :meth:`batch_eps` at the padded length."""
        mel = np.asarray(mel, np.float32)
        b, t, _ = mel.shape
        if lengths is None:
            lengths = np.full((b,), t, np.int64)
        padded_t = self._bucket(t)
        mel = np.pad(mel, ((0, 0), (0, padded_t - t), (0, 0)))
        if eps is None:
            eps_t = self.batch_eps(seed, b, padded_t)
        else:
            eps = np.asarray(eps, np.float32)
            eps_t = torch.from_numpy(np.pad(eps, ((0, 0), (0, padded_t - eps.shape[1]), (0, 0))))
        dev = self.device
        infer = (self._apply_infer_fast if self.use_kernels or self.use_wn_kernels
                 else self._apply_infer)
        o = infer(torch.from_numpy(mel).to(dev),
                  torch.as_tensor(np.asarray(lengths), dtype=torch.int64, device=dev),
                  eps_t.to(dev), noise_scale,
                  None if sid is None else torch.as_tensor(np.asarray(sid), device=dev))
        o = o.float().cpu().numpy()
        hop = self.hps.data.hop_length
        return [o[i, : int(lengths[i]) * hop, 0] for i in range(b)]

    def wav_to_wav(self, wav: np.ndarray, **kw) -> np.ndarray:
        """Copy-synthesis: waveform -> mel -> waveform (notebook cell 4)."""
        wav = np.asarray(wav, np.float32).reshape(1, -1)
        hop = self.hps.data.hop_length
        wav = torch.from_numpy(wav[:, : (wav.shape[1] // hop) * hop])
        mel = spec_to_mel(spectrogram(wav, self.mel_cfg), self.mel_cfg)
        return self.mel_to_wav(mel.numpy(), **kw)[0]

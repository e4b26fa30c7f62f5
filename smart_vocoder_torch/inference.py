"""Inference API: the mel -> wav product path.

Counterpart of ``smart_vocoder_tpu/inference.py:Vocoder``: a weight-norm-folded
``SynthesizerTrn`` with bucketed padding, so arbitrary lengths map onto a
bounded set of shapes. The serving path (``_apply_infer_fast``) runs the prior
and the reverse flow through the module graph, or with ``use_wn_kernels``
through ``kernels/encoder.py:prior_flow_apply`` (every WN stack on the CUDA
WN kernel), and the decoder through ``kernels/decoder.py:decoder_apply``,
whose late stages are the hand-written CUDA kernels; ``_apply_infer`` is the
plain module graph.

Long and live input (``smart_vocoder_tpu/inference.py:298-516``): the model is
fully convolutional, so ``mel_to_wav_chunked`` and ``stream_mel_to_wav`` decode
overlapping windows of one fixed ``chunk`` shape (``_synth_window``) and keep
each window's interior. The prior noise of a window comes from
``ops.noise.positional_eps``, keyed by the absolute frame, so overlapping
windows see the same latents and a stream equals the chunked decode bit for
bit. ``serving.StreamServer`` batches the windows of many streams.

Several cards (``smart_vocoder_tpu/inference.py:110-142``, ``Vocoder(mesh=...)``
over the ``'data'`` axis): ``Vocoder(devices=[...])`` holds one replica of the
weights a distinct device and splits a ``mel_to_wav`` batch into one block of
rows a listed device (``parallel.split_rows``), each decoded on its device's
worker thread. Row i's noise is keyed by (seed, i) over the whole batch, so
the audio does not depend on the split.
"""

from __future__ import annotations

import bisect
import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Iterable, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch

from smart_vocoder_torch.config import HParams, load_config
from smart_vocoder_torch.kernels._build import load_library
from smart_vocoder_torch.kernels.decoder import DecoderConfig, decoder_apply, pack_decoder
from smart_vocoder_torch.kernels.encoder import pack_prior_flow, prior_flow_apply
from smart_vocoder_torch.models import build_synthesizer
from smart_vocoder_torch.nn import fold_weight_norm
from smart_vocoder_torch.ops import (
    MelConfig,
    positional_eps,
    sequence_mask,
    spec_to_mel,
    spectrogram,
)
from smart_vocoder_torch.parallel.devices import check_devices, split_rows
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
                 use_wn_kernels: bool | None = None,
                 devices: Sequence[str | torch.device] | None = None):
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
        and ``hidden_channels % 64 == 0``.

        ``devices`` (the JAX ``mesh``; not with ``device``): one shard of a
        ``mel_to_wav`` batch per entry, and one replica of the weights per
        distinct device, each made here with a worker thread of its own; a
        device named twice decodes its shards one after the other on that
        thread. The first device's replica is this
        object's own (``net``, ``params``, ``dec_packed``, ``device``); the
        windows (``_synth_window`` and its callers) decode there."""
        if devices is not None:
            if device is not None:
                raise ValueError("pass device= or devices=, not both")
            devices = check_devices(devices)
            device = devices[0]
        set_precision_flags()
        self.hps = hps
        self.device = resolve_device(device)
        self.devices = devices or [self.device]
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
        self._workers = {}
        if len(self.devices) > 1:
            if (self.use_kernels or self.use_wn_kernels) and any(
                    d.type == "cuda" for d in self.devices):
                load_library()  # built here, not by the first of several workers
            self._replicas = {self.device: self}
            for d in self.devices:
                if d not in self._replicas:
                    self._replicas[d] = Vocoder(  # state_dict is folded already
                        hps, state_dict, dtype=dtype, buckets=buckets, fold=fold,
                        use_kernels=self.use_kernels, hifi=self.hifi,
                        use_wn_kernels=self.use_wn_kernels, device=d)
            # one thread a device, for good: cuDNN keeps its plans (and with
            # cudnn.benchmark its timed choices) per thread, so a device's
            # shards find them there at every call
            self._workers = {d: ThreadPoolExecutor(1, thread_name_prefix=f"shard-{d}")
                             for d in self._replicas}

    def close(self) -> None:
        """Stop the shards' worker threads (a one-device ``Vocoder`` has none)."""
        for worker in self._workers.values():
            worker.shutdown()

    @classmethod
    def from_torch_checkpoint(cls, config_path: str, pth_path: str, **kw) -> "Vocoder":
        """Load a reference ``G_*.pth`` (notebook cell 3); ``device`` and
        ``devices`` as in ``__init__`` (the checkpoint itself is read on the CPU)."""
        if kw.get("devices") is None:  # the device rule, before any file is read
            kw["device"] = resolve_device(kw.get("device"))
        else:
            kw["devices"] = check_devices(kw["devices"])
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

    def _infer(self, mel, lengths, eps, noise_scale, sid=None):
        """The serving program: ``_apply_infer_fast`` where a kernel route is
        on, else the plain module graph. ``noise_scale``: a float or one per
        row ``(B,)``."""
        fn = (self._apply_infer_fast if self.use_kernels or self.use_wn_kernels
              else self._apply_infer)
        return fn(mel, lengths, eps, noise_scale, sid)

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
        by :meth:`batch_eps` at the padded length. Over several ``devices``
        the rows, with their noise and ``sid``, are split by ``split_rows``
        and the shards' audio joined in order; a shard's exception is raised
        here."""
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
        if len(self.devices) == 1:
            o = self._decode_rows(mel, lengths, eps_t, noise_scale, sid)
        else:
            sid = None if sid is None else np.asarray(sid)
            lens = np.asarray(lengths)
            shards = [self._workers[d].submit(self._shard, d, mel[r], lens[r], eps_t[r],
                                              noise_scale, None if sid is None else sid[r])
                      for d, r in zip(self.devices, split_rows(b, len(self.devices)))
                      if r.stop > r.start]
            wait(shards)  # every shard ends before a failed one raises
            o = np.concatenate([f.result() for f in shards])
        hop = self.hps.data.hop_length
        return [o[i, : int(lengths[i]) * hop, 0] for i in range(b)]

    def _decode_rows(self, mel, lengths, eps, noise_scale, sid) -> np.ndarray:
        """``_infer`` of host rows on this object's device, read back to the host."""
        dev = self.device
        o = self._infer(torch.from_numpy(mel).to(dev),
                        torch.as_tensor(np.asarray(lengths), dtype=torch.int64, device=dev),
                        eps.to(dev), noise_scale,
                        None if sid is None else torch.as_tensor(np.asarray(sid), device=dev))
        return o.float().cpu().numpy()

    def _shard(self, device, mel, lengths, eps, noise_scale, sid) -> np.ndarray:
        """One shard on its device's worker thread: that device's replica, with
        the card current in the thread (and so its stream)."""
        card = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
        with card:
            return self._replicas[device]._decode_rows(mel, lengths, eps, noise_scale, sid)

    def wav_to_wav(self, wav: np.ndarray, **kw) -> np.ndarray:
        """Copy-synthesis: waveform -> mel -> waveform (notebook cell 4)."""
        wav = np.asarray(wav, np.float32).reshape(1, -1)
        hop = self.hps.data.hop_length
        wav = torch.from_numpy(wav[:, : (wav.shape[1] // hop) * hop])
        mel = spec_to_mel(spectrogram(wav, self.mel_cfg), self.mel_cfg)
        return self.mel_to_wav(mel.numpy(), **kw)[0]

    # -- windows: chunked and streaming synthesis ----------------------------
    def warmup(self, chunks: Optional[Sequence[int]] = None,
               sid: Optional[np.ndarray] = None) -> None:
        """Run the window program once for each chunk size (default: every
        bucket), so that a live session's first window pays none of the
        one-off costs: the kernel library's first load, cuDNN's plan choice
        for the shape, the allocator's growth. Pass ``sid`` when serving a
        speaker-conditioned model (the conditioned prior runs other
        operations)."""
        n_mels = int(self.hps.data.n_mel_channels)
        for c in chunks or self.buckets:
            self._synth_window(np.zeros((c, n_mels), np.float32), 0, c, 0.667, sid, 0)

    def _synth_window(self, mel_win: np.ndarray, lo: int, chunk: int,
                      noise_scale: float, sid, seed: int) -> np.ndarray:
        """Decode one window (absolute frames ``[lo, lo + len)``) padded to
        ``chunk`` frames, so one shape serves every window. Its prior noise is
        ``positional_eps(seed, lo)`` over all ``chunk`` frames, made on the
        device; the padded frames' noise is masked out of every valid sample,
        as in JAX's in-graph route (``_positional_eps_graph``)."""
        mel_win = np.asarray(mel_win, np.float32)
        n = mel_win.shape[0]
        if chunk > n:
            mel_win = np.pad(mel_win, ((0, chunk - n), (0, 0)))
        dev = self.device
        eps = positional_eps([seed], [lo], chunk, int(self.hps.model.inter_channels), dev)
        o = self._infer(torch.from_numpy(mel_win)[None].to(dev),
                        torch.full((1,), n, dtype=torch.int64, device=dev), eps, noise_scale,
                        None if sid is None else torch.as_tensor(np.asarray(sid), device=dev))
        return o[0, : n * self.hps.data.hop_length, 0].float().cpu().numpy()

    @staticmethod
    def _check_window(chunk: int, overlap: int) -> int:
        """The frames a window keeps: ``chunk - 2 * overlap``."""
        if not 0 <= overlap < chunk // 2:
            raise ValueError(f"overlap {overlap} must lie in [0, chunk // 2) for chunk {chunk}")
        return chunk - 2 * overlap

    def mel_to_wav_chunked(self, mel: np.ndarray, chunk: int = 1024, overlap: int = 128,
                           noise_scale: float = 0.667, sid: Optional[np.ndarray] = None,
                           seed: int = 0) -> np.ndarray:
        """Any-length synthesis by fixed-size windows with receptive-field
        overlap: every output sample depends only on a local mel window (prior
        WN radius 32 + flow 4 x WN8 radius 64, ~96 frames), so decoding
        overlapping windows and keeping each one's interior leaves no seam
        once ``overlap`` covers the radius. One window shape serves any
        length; the noise is position-keyed, so this equals
        ``stream_mel_to_wav`` on the same input bit for bit.

        mel: (T, n_mels) or (1, T, n_mels) -> (T * hop,) float32 waveform."""
        mel = np.asarray(mel, np.float32)
        if mel.ndim == 3:
            mel = mel[0]
        t = mel.shape[0]
        hop = self.hps.data.hop_length
        step = self._check_window(chunk, overlap)
        if t <= step:  # one window, as stream_mel_to_wav's single-window case
            return self._synth_window(mel, 0, chunk, noise_scale, sid, seed)
        out = np.zeros(t * hop, np.float32)
        for start in range(0, t, step):
            lo, hi = max(0, start - overlap), min(t, start + step + overlap)
            wav = self._synth_window(mel[lo:hi], lo, chunk, noise_scale, sid, seed)
            keep_hi = min(hi, start + step)  # absolute end frame of the kept part
            out[start * hop: keep_hi * hop] = wav[(start - lo) * hop: (keep_hi - lo) * hop]
        return out

    def stream_mel_to_wav(self, mel_chunks: Iterable[np.ndarray], chunk: int = 1024,
                          overlap: int = 128, noise_scale: float = 0.667,
                          sid: Optional[np.ndarray] = None, seed: int = 0) -> Iterator[np.ndarray]:
        """Streaming synthesis: consume mel pieces ``(T_i, n_mels)`` (or
        ``(1, T_i, n_mels)``) of any sizes as they arrive, yield waveform
        pieces in order. The pieces concatenate to exactly
        ``mel_to_wav_chunked`` of the whole mel with the same (chunk,
        overlap, seed): windows are cut at the same absolute frames. A window
        is emitted once ``step + overlap`` frames past its start are buffered
        (``step = chunk - 2 * overlap``); memory is O(chunk) whatever the
        stream's length."""
        hop = self.hps.data.hop_length
        step = self._check_window(chunk, overlap)
        buf = np.zeros((0, int(self.hps.data.n_mel_channels)), np.float32)
        buf0 = 0   # absolute frame of buf[0]
        start = 0  # absolute frame of the next emission

        def emit(start, end):
            lo, hi = max(0, start - overlap), min(end, start + step + overlap)
            wav = self._synth_window(buf[lo - buf0: hi - buf0], lo, chunk, noise_scale, sid, seed)
            keep_hi = min(hi, start + step)
            return wav[(start - lo) * hop: (keep_hi - lo) * hop], keep_hi

        for piece in mel_chunks:
            piece = np.asarray(piece, np.float32)
            buf = np.concatenate([buf, piece[0] if piece.ndim == 3 else piece])
            while buf0 + len(buf) >= start + step + overlap:
                wav, start = emit(start, buf0 + len(buf))
                yield wav
                keep_from = max(0, start - overlap - buf0)
                buf, buf0 = buf[keep_from:], buf0 + keep_from
        end = buf0 + len(buf)
        while start < end:  # flush the tail
            wav, start = emit(start, end)
            yield wav

"""Multi-stream live serving: the windows of N concurrent streams in one
decode of a fixed ``(max_streams, chunk)`` shape.

Counterpart of ``smart_vocoder_tpu/serving.py``. A B = 1 window decode leaves
most of the card idle; ``StreamServer`` fills a batch with the windows of
independent live sessions instead. That changes no stream's audio: the prior
noise of frame ``t`` of a stream is ``positional_eps(seed, t)``, whatever row
or co-tenants it has; the model has no operation across batch rows; and
every per-stream setting (seed, speaker, noise scale) rides the batch row.
The noise scale of a row is rounded to the prior's dtype as the B = 1 path
rounds its float (``ops.noise.prior_sample``). So a stream's pieces equal its
decode alone through ``Vocoder.stream_mel_to_wav`` with the same (chunk,
overlap, seed, sid, noise_scale) up to the summation order that the
convolutions choose for another batch size (a server of one row gives the
same bits). Within one server the shape never changes, so a stream's audio
is bit-identical whatever row it lands in and whoever shares the batch.

Scheduling: a stream's window is ready once ``step + overlap`` frames past its
cursor are buffered (``step = chunk - 2 * overlap``), or at once after
``close``. Each ``step()`` decodes up to ``max_streams`` ready windows, the
streams furthest behind first; idle rows have length 0 (fully masked).

The decode is one program, as JAX's one ``jax.jit(batched_windows)``: a CUDA
graph of ``Vocoder._decode_windows`` at ``(max_streams, chunk)``, held by the
vocoder (``programs.ServingProgram``), captured at ``warmup`` or at the first
step and replayed at every step, each row's seed, first frame, noise scale,
length and speaker in its static buffers.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, Optional

import numpy as np

from smart_vocoder_torch.inference import Vocoder
from smart_vocoder_torch.programs import ServingProgram
from smart_vocoder_torch.utils.profiling import span


@dataclass
class _Stream:
    """One stream's cursor state: the locals of ``stream_mel_to_wav``."""

    seed: int
    sid: Optional[int]
    noise_scale: float
    buf: np.ndarray          # buffered mel frames not yet fully consumed
    buf0: int = 0            # absolute frame of buf[0]
    start: int = 0           # absolute frame of the next emission
    closed: bool = False     # no more feed() calls will come

    def end(self) -> int:
        return self.buf0 + len(self.buf)

    def ready(self, step: int, overlap: int) -> bool:
        if self.closed:
            return self.start < self.end()
        return self.end() >= self.start + step + overlap


class StreamServer:
    """Batch the windows of concurrent live streams into one decode.

    Usage::

        server = StreamServer(vocoder, max_streams=8, chunk=384, overlap=96)
        h = server.open(seed=7, sid=3)        # a stream handle
        server.feed(h, mel_piece)             # (T_i, n_mels), any sizes
        for h, wav in server.step().items():  # one batched decode
            play(h, wav)
        server.close(h)                       # end of stream: step() flushes

    ``step()`` returns ``{handle: waveform piece}`` for every stream that
    emitted; a handle's pieces concatenate to its whole decode.
    """

    def __init__(self, vocoder: Vocoder, max_streams: int = 8, chunk: int = 384,
                 overlap: int = 96):
        if len(vocoder.devices) > 1:
            raise ValueError("StreamServer batches over the batch axis itself; run one server "
                             "per card instead of a multi-device Vocoder")
        self.voc = vocoder
        self.max_streams = int(max_streams)
        self.chunk = int(chunk)
        self.overlap = int(overlap)
        self.step_frames = vocoder._check_window(self.chunk, self.overlap)
        self.hop = int(vocoder.hps.data.hop_length)
        self.n_mels = int(vocoder.hps.data.n_mel_channels)
        self._streams: Dict[int, _Stream] = {}
        self._ids = itertools.count()
        self._with_sid = vocoder.net.emb_g is not None

    # -- stream lifecycle ------------------------------------------------------
    def open(self, seed: int = 0, sid: Optional[int] = None,
             noise_scale: float = 0.667) -> int:
        """Register a new stream and return its handle. ``sid`` selects the
        speaker of a speaker-conditioned model and is ignored otherwise, as
        in ``Vocoder``."""
        h = next(self._ids)
        self._streams[h] = _Stream(seed=int(seed), sid=sid, noise_scale=float(noise_scale),
                                   buf=np.zeros((0, self.n_mels), np.float32))
        return h

    def feed(self, handle: int, mel_piece: np.ndarray) -> None:
        """Append mel frames ((T, n_mels) or (1, T, n_mels)) to a stream."""
        s = self._streams[handle]
        if s.closed:
            raise ValueError(f"stream {handle} is closed")
        piece = np.asarray(mel_piece, np.float32)
        s.buf = np.concatenate([s.buf, piece[0] if piece.ndim == 3 else piece])

    def close(self, handle: int) -> None:
        """Mark the end of a stream; later ``step()`` calls flush its tail."""
        s = self._streams[handle]
        s.closed = True
        if s.start >= s.end():
            del self._streams[handle]

    def pending(self) -> int:
        """The number of streams with a window ready to decode."""
        return sum(s.ready(self.step_frames, self.overlap) for s in self._streams.values())

    def warmup(self) -> None:
        """Make the batched window program (its one shape) on idle rows: one
        eager call, then the capture of its CUDA graph."""
        self._program(self._batch([])[0])

    # -- the scheduler ---------------------------------------------------------
    def step(self) -> Dict[int, np.ndarray]:
        """Decode up to ``max_streams`` ready windows in one batch.

        Returns ``{handle: float32 waveform piece}`` for each stream that
        emitted. Streams without a ready window are skipped; when more than
        ``max_streams`` are ready, those with the oldest cursor go first and
        the rest wait for the next call.

        A step that decodes records the span ``serve.step`` (``windows``,
        ``max_streams``, ``handles``: the streams decoded) while a profiler
        runs (``utils/profiling.py``)."""
        ready = [(h, s) for h, s in self._streams.items()
                 if s.ready(self.step_frames, self.overlap)]
        if not ready:
            return {}
        ready.sort(key=lambda hs: (hs[1].start, hs[0]))
        ready = ready[: self.max_streams]
        with span("serve.step", windows=len(ready), max_streams=self.max_streams,
                  handles=[h for h, _ in ready]):
            out: Dict[int, np.ndarray] = {}
            for (h, s), (lo, hi, wav) in zip(ready, self._decode_batch(ready)):
                keep_hi = min(hi, s.start + self.step_frames)
                out[h] = wav[(s.start - lo) * self.hop: (keep_hi - lo) * self.hop]
                s.start = keep_hi
                keep_from = max(0, s.start - self.overlap - s.buf0)
                s.buf, s.buf0 = s.buf[keep_from:], s.buf0 + keep_from
                if s.closed and s.start >= s.end():
                    del self._streams[h]
            return out

    def _program(self, inputs) -> ServingProgram:
        """This shape's program, made at its first use on ``inputs``."""
        return self.voc._program(("server", self.max_streams, self.chunk, self._with_sid),
                                 self.voc._decode_windows, inputs)

    def _decode_batch(self, ready):
        """Decode the ready windows through the program: ``[(lo, hi, wav)]``
        a window, its absolute frames and its waveform."""
        inputs, spans = self._batch(ready)
        o = self._program(inputs).run(**inputs).float().numpy()
        return [(lo, hi, o[r, : (hi - lo) * self.hop, 0]) for r, (lo, hi) in enumerate(spans)]

    def _batch(self, ready):
        """The program's inputs for the ready windows padded into the fixed
        ``(max_streams, chunk)`` shape, and each window's span; idle rows have
        length 0. Each row's noise is ``positional_eps`` from its own seed and
        first frame, and its noise scale and speaker ride the row."""
        n = self.max_streams
        mel = np.zeros((n, self.chunk, self.n_mels), np.float32)
        lengths = np.zeros((n,), np.int64)
        seeds = np.zeros((n,), np.int64)
        starts = np.zeros((n,), np.int64)
        noise_scales = np.full((n,), 0.667, np.float32)
        sids = np.zeros((n,), np.int64)
        spans = []
        for r, (_, s) in enumerate(ready):
            lo = max(0, s.start - self.overlap)
            hi = min(s.end(), s.start + self.step_frames + self.overlap)
            mel[r, : hi - lo] = s.buf[lo - s.buf0: hi - s.buf0]
            lengths[r], seeds[r], starts[r] = hi - lo, s.seed, lo
            noise_scales[r] = s.noise_scale
            if s.sid is not None:
                sids[r] = int(s.sid)
            spans.append((lo, hi))
        inputs = {"mel": mel, "lengths": lengths, "seeds": seeds, "starts": starts,
                  "noise_scale": noise_scales}
        if self._with_sid:
            inputs["sid"] = sids
        return inputs, spans

    # -- convenience -----------------------------------------------------------
    def run(self, feeds: Dict[int, Iterable[np.ndarray]]) -> Iterator[tuple[int, np.ndarray]]:
        """Drive open streams from iterables to their end.

        ``feeds`` maps handle -> iterable of mel pieces. Yields ``(handle,
        waveform piece)`` in emission order; one piece is pulled per stream
        per round (live pacing), and batched decodes run while any stream
        has a ready window."""
        iters = {h: iter(it) for h, it in feeds.items()}
        while iters or self.pending():
            for h in list(iters):
                try:
                    self.feed(h, next(iters[h]))
                except StopIteration:
                    del iters[h]
                    self.close(h)
            while self.pending():
                yield from self.step().items()

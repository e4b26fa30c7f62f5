"""Batch assembly at static bucket shapes, with background prefetch;
counterpart of ``smart_vocoder_tpu/data/pipeline.py``.

Every batch is zero-padded to its bucket's *upper boundary* (the reference
pads to the longest sample, data_utils.py:83-127), so a run sees at most
``len(boundaries) - 1`` shapes, and the wav to ``frames * hop`` samples,
keeping ``wav_len == spec_len * hop`` for the slicing. A thread pool, alive
as long as the loader, reads and transforms the items of ``prefetch + 1``
batches ahead of the one being collated (numpy's FFT and the native reader
run without the interpreter lock); a producer thread collates them in order
into a bounded queue. For the card, the producer pins each batch's memory
and the consumer copies it with ``non_blocking=True``. While a profiler runs,
the consumer's wait for each batch is the span ``loader.wait`` (``empty``: the
queue held no batch when it asked; ``utils/profiling.py``).
"""

from __future__ import annotations

import queue
import threading
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from smart_vocoder_torch.data.dataset import AudioSpecDataset
from smart_vocoder_torch.data.sampler import BucketSampler
from smart_vocoder_torch.training.step import Batch
from smart_vocoder_torch.utils.profiling import span


def pad_to_bucket(items: Sequence[tuple], frames: int, hop: int, with_sid: bool) -> Batch:
    """Collate (spec, wav, sid) tuples into one zero-padded batch of CPU
    tensors, longest wav first as AudioSpecCollate sorts (data_utils.py:94-96).
    A sample longer than the bucket is cut with a warning: its length estimate
    and its bucket disagree."""
    items = sorted(items, key=lambda it: it[1].shape[0], reverse=True)
    n = len(items)
    n_bins = items[0][0].shape[1]
    spec = np.zeros((n, frames, n_bins), np.float32)
    wav = np.zeros((n, frames * hop, 1), np.float32)
    spec_lengths = np.zeros((n,), np.int32)
    wav_lengths = np.zeros((n,), np.int32)
    sid = np.zeros((n,), np.int32) if with_sid else None

    for i, (s, w, s_id) in enumerate(items):
        if s.shape[0] > frames:
            warnings.warn(
                f"sample with {s.shape[0]} spec frames exceeds its bucket boundary {frames}; "
                f"truncating. Length estimation and the bucket assignment disagree -- check "
                f"the wav header parse.", stacklevel=2)
        t = min(s.shape[0], frames)
        spec[i, :t] = s[:t]
        wav[i, : t * hop] = w[: t * hop]
        spec_lengths[i] = t
        wav_lengths[i] = t * hop
        if with_sid:
            sid[i] = 0 if s_id is None else s_id

    return Batch(spec=torch.from_numpy(spec), spec_lengths=torch.from_numpy(spec_lengths),
                 wav=torch.from_numpy(wav), wav_lengths=torch.from_numpy(wav_lengths),
                 sid=None if sid is None else torch.from_numpy(sid))


class BucketedLoader:
    """Iterable over one epoch of static-shape ``Batch``es on ``device``
    (the CPU unless given)."""

    def __init__(self, dataset: AudioSpecDataset, sampler: BucketSampler,
                 with_sid: bool = False, num_workers: int = 8, prefetch: int = 4,
                 device=None):
        self.dataset = dataset
        self.sampler = sampler
        self.with_sid = with_sid
        self.prefetch = prefetch
        self.hop = dataset.hop_length
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self._pool = ThreadPoolExecutor(max_workers=num_workers, thread_name_prefix="loader")

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self) -> Iterator[Batch]:
        return self.iter_from(0)

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)

    def iter_from(self, skip: int = 0) -> Iterator[Batch]:
        """This epoch's batches from batch index ``skip`` on: the order is
        epoch-seeded, so a resumed run replays the consumed prefix exactly
        and skips it."""
        batches = list(iter(self.sampler))[skip:]
        pin = self.device.type == "cuda"
        q: "queue.Queue[Optional[Batch]]" = queue.Queue(maxsize=self.prefetch)
        err: List[BaseException] = []
        stop = threading.Event()  # the consumer is gone: release the producer

        def put(item) -> bool:
            """``q.put`` that gives up once the consumer abandoned the
            iterator; a plain blocking put would pin this thread on a full
            queue for good (the eval abandons an iterator every time)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                pending: deque = deque()
                it = iter(batches)

                def submit_next() -> bool:
                    idxs = next(it, None)
                    if idxs is None:
                        return False
                    pending.append((idxs, [self._pool.submit(self.dataset.__getitem__, i)
                                           for i in idxs]))
                    return True

                for _ in range(self.prefetch + 1):
                    if not submit_next():
                        break
                while pending and not stop.is_set():
                    idxs, futs = pending.popleft()
                    items = [f.result() for f in futs]
                    batch = pad_to_bucket(items, self.sampler.bucket_boundary(idxs), self.hop,
                                          self.with_sid)
                    if not put(batch.pin_memory() if pin else batch):
                        break
                    submit_next()
                for _, futs in pending:  # abandoned
                    for f in futs:
                        f.cancel()
            except BaseException as e:  # noqa: BLE001 -- raised again in the consumer
                err.append(e)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            for _ in batches:  # the producer puts each batch, or None once it failed
                with span("loader.wait", empty=q.empty()):
                    item = q.get()
                if item is None:
                    break
                yield item.to(self.device, non_blocking=pin)
            t.join()
            if err:
                raise err[0]
        finally:
            # also on GeneratorExit (a consumer that breaks out): release the producer
            stop.set()
            t.join(timeout=5.0)

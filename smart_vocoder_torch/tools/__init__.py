"""Measurement entry points of the port (counterparts of the JAX ``scripts/``
A/B tools), run as ``python -m smart_vocoder_torch.tools.<name>``."""

from __future__ import annotations

import time

import torch


def time_ms(fn, iters: int, device: torch.device) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` calls after one warm-up
    call: the host clock around work that ends in a device synchronize."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters * 1e3


def device_busy_ms(fn, device: torch.device) -> float | None:
    """Milliseconds the card spends in the kernels of one ``fn()`` call, summed
    under ``torch.profiler``; ``None`` on the CPU. Beside a host-clock time it
    says whether the host or the card bounds the call."""
    if device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3

"""Data parallelism over processes (counterpart of ``smart_vocoder_tpu/parallel``)."""

from smart_vocoder_torch.parallel.devices import data_devices, split_rows

__all__ = ["data_devices", "split_rows"]

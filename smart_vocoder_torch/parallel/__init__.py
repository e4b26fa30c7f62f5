"""Data and model axes over processes (counterpart of ``smart_vocoder_tpu/parallel``)."""

from smart_vocoder_torch.parallel.devices import data_devices, split_rows
from smart_vocoder_torch.parallel.mesh import Mesh, leaf_sharded

__all__ = ["Mesh", "data_devices", "leaf_sharded", "split_rows"]

"""Data pipeline (counterpart of ``smart_vocoder_tpu/data``): the filelist
dataset, the bucket sampler and the prefetching loader."""

from smart_vocoder_torch.data.dataset import AudioSpecDataset, load_filepaths, load_wav
from smart_vocoder_torch.data.pipeline import BucketedLoader, pad_to_bucket
from smart_vocoder_torch.data.sampler import BucketSampler

__all__ = [
    "AudioSpecDataset",
    "BucketSampler",
    "BucketedLoader",
    "load_filepaths",
    "load_wav",
    "pad_to_bucket",
]

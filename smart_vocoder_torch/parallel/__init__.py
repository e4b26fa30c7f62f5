"""Data parallelism over processes (counterpart of ``smart_vocoder_tpu/parallel``)."""

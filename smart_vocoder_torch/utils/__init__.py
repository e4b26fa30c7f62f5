"""Weight bridge and seeded init (counterpart of ``smart_vocoder_tpu/utils``)."""

"""The benchmark of smart_vocoder_torch: see vocbench/run.py."""

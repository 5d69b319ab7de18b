"""Benchmark of the PyTorch and CUDA port (montecarlooptionspricer_tpu_torch): see gpubench/run.py."""

"""Builds and loads the CUDA sources under ``csrc/``."""

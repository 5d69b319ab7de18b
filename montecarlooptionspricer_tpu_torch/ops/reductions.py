"""Reductions (counterpart: ``montecarlooptionspricer_tpu/ops/reductions.py``).

Single device only: the port has no mesh yet, so there is no ``psum``.
"""

from __future__ import annotations

import torch


def global_mean(values: torch.Tensor) -> torch.Tensor:
    """Plain mean over every element."""
    return torch.sum(values) / values.numel()

"""Option payoff (counterpart: ``montecarlooptionspricer_tpu/ops/payoff.py``)."""

from __future__ import annotations

import torch


def payoff(is_call: bool, s: torch.Tensor, strike) -> torch.Tensor:
    """``max(0, s - k)`` for calls, ``max(0, k - s)`` for puts."""
    diff = s - strike
    return torch.clamp_min(diff if is_call else -diff, 0.0)

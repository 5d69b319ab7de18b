"""Option payoff (counterpart: ``montecarlooptionspricer_tpu/ops/payoff.py``)."""

from __future__ import annotations

import torch


def payoff(is_call, s: torch.Tensor, strike) -> torch.Tensor:
    """``max(0, s - k)`` for calls, ``max(0, k - s)`` for puts.  ``is_call``
    is a bool, or a boolean tensor that broadcasts against ``s`` (one
    option type per row of a batch)."""
    diff = s - strike
    if isinstance(is_call, torch.Tensor):
        return torch.clamp_min(torch.where(is_call, diff, -diff), 0.0)
    return torch.clamp_min(diff if is_call else -diff, 0.0)

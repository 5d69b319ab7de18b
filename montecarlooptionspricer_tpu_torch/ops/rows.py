"""Per-row arguments of the PredictionGen estimators, which price a batch
of rows, each with its own option, in one set of launches."""

from __future__ import annotations

import torch


def per_row(a, rows: int, device, dtype=torch.float32) -> torch.Tensor:
    """A [rows] tensor from a number (the same for every row) or a [rows]
    array-like."""
    t = torch.as_tensor(a, dtype=dtype, device=device)
    return t.expand(rows) if t.dim() == 0 else t


def discount_curve(r: float, m: int, dt: float, device,
                   maturity=None) -> torch.Tensor:
    """float32 factors exp(-r t) at t = j dt, j < m: [m], or [rows, m] with t
    clamped at a [rows] ``maturity``.  Formed in float64 and rounded once,
    so the card's and the host's exp give the same bits."""
    t = torch.arange(m, dtype=torch.float64, device=device) * dt
    if maturity is not None:
        t = torch.minimum(t[None, :], maturity.to(torch.float64)[:, None])
    return torch.exp(-r * t).to(torch.float32)

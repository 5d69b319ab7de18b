"""Reductions (counterpart: ``montecarlooptionspricer_tpu/ops/reductions.py``).

Single device only: the port has no mesh yet, so there is no ``psum``.

``row_sum`` and ``row_mean`` serve the PredictionGen path, whose rows are
priced in batches that change with the run (a resumed run batches the
rows it has left).  A library reduction chooses how to split a sum from
the whole tensor's shape and a row's alignment, so a row's bits would
follow its batch.  These sum by pairwise halving in elementwise adds,
whose order depends on the reduced length alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .fgn import next_pow2


def global_mean(values: torch.Tensor) -> torch.Tensor:
    """Plain mean over every element."""
    return torch.sum(values) / values.numel()


def row_sum(x: torch.Tensor, dim: int = -1,
            keepdim: bool = False) -> torch.Tensor:
    """Sum along ``dim`` by pairwise halving (zero-padded to a power of
    two): the same bits for a row whatever else the batch holds."""
    y = x.movedim(dim, -1)
    n = y.shape[-1]
    if next_pow2(n) != n:
        y = F.pad(y, (0, next_pow2(n) - n))
    while y.shape[-1] > 1:
        h = y.shape[-1] // 2
        y = y[..., :h] + y[..., h:]
    out = y[..., 0]
    if keepdim:
        out = out.unsqueeze(dim)
    return out


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis, summed as ``row_sum`` does."""
    return row_sum(x) / x.shape[-1]

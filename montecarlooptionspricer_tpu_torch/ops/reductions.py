"""Reductions (counterpart: ``montecarlooptionspricer_tpu/ops/reductions.py``).

Across a mesh (``parallel.mesh``) a sum over the sharded paths is an
``all_reduce`` (SUM) over the process group, where JAX takes a ``psum``
over the mesh axis: each function takes a ``group`` where JAX takes its
``axis_name``, and with ``group=None`` runs no collective and is the
one-device code.  At a world of one the group's all-reduce returns its
input, so a fit through a group of one rank has the bits of the fit with
none.

``row_sum`` and ``row_mean`` serve the PredictionGen path, whose rows are
priced in batches that change with the run (a resumed run batches the
rows it has left).  A library reduction chooses how to split a sum from
the whole tensor's shape and a row's alignment, so a row's bits would
follow its batch.  These sum by pairwise halving in elementwise adds,
whose order depends on the reduced length alone.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .fgn import next_pow2


def psum_if(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (a fresh tensor), or ``x``
    itself when ``group`` is None."""
    if group is None:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def psum_all(*xs: torch.Tensor, group=None) -> tuple:
    """``psum_if`` of each of ``xs`` (one dtype and device) in one
    all-reduce of their concatenation; ``xs`` unchanged without a
    group."""
    if group is None:
        return xs
    flat = psum_if(torch.cat([x.reshape(-1) for x in xs]), group)
    return tuple(p.view_as(x) for p, x in
                 zip(flat.split([x.numel() for x in xs]), xs))


def gather_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """[size, *x.shape]: every rank's ``x``, in rank order, on every rank
    (one all-reduce of a zero-filled buffer holding ``x`` at this rank's
    slot: NCCL and gloo take it alike)."""
    out = torch.zeros((dist.get_world_size(group), *x.shape), dtype=x.dtype,
                      device=x.device)
    out[dist.get_rank(group)] = x
    dist.all_reduce(out, group=group)
    return out


def masked_mean(values, mask, group=None) -> torch.Tensor:
    """sum(values * mask) / sum(mask) over every rank of ``group``; 0 when
    the mask is empty (the reference's validPaths guard)."""
    num, den = psum_all(torch.sum(values * mask), torch.sum(mask).to(
        values.dtype), group=group)
    # Divide by den itself (guarded only to keep the untaken branch
    # finite): maximum(den, 1) would halve the mean of fractional weights
    # that sum to 0.5.
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def global_mean(values: torch.Tensor, group=None) -> torch.Tensor:
    """Plain mean over every element, on every rank of ``group``."""
    if group is None:
        return torch.sum(values) / values.numel()
    num, den = psum_all(torch.sum(values),
                        torch.tensor(float(values.numel()),
                                     dtype=values.dtype,
                                     device=values.device), group=group)
    return num / den


def mean_last(values: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the last axis, pooled over the ranks of ``group``."""
    if group is None:
        return torch.mean(values, dim=-1)
    num, den = psum_all(torch.sum(values, dim=-1),
                        torch.tensor([float(values.shape[-1])],
                                     dtype=values.dtype,
                                     device=values.device), group=group)
    return num / den


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


def row_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the last axis, summed as ``row_sum`` does, then over the
    ranks of ``group``."""
    if group is None:
        return row_sum(x) / x.shape[-1]
    num, den = psum_all(row_sum(x), torch.tensor(
        [float(x.shape[-1])], dtype=x.dtype, device=x.device), group=group)
    return num / den

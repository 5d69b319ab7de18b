"""Per-row random streams of the PredictionGen path (counterpart:
``montecarlooptionspricer_tpu/ops/rng.py``).

JAX folds a row's index into one threefry key (``key_for_row``), so a
row's draws never depend on the batch it lands in.  Here each row gets a
``torch.Generator`` of its own on the row's device, seeded from
(seed, row index) through a 64-bit bijection; the row then draws its
planes from it in a fixed order.  The card's Philox generator takes the
whole 64-bit seed; the CPU's Mersenne twister keeps its low 32 bits,
which the mix makes depend on every bit of both words.  The streams are
torch's, so they match JAX's in distribution only.
"""

from __future__ import annotations

import torch

_M64 = (1 << 64) - 1


def mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit words whose low 32
    bits depend on every input bit."""
    z = (x + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def row_seed(seed: int, row_index: int) -> int:
    """The 64-bit seed of row ``row_index`` of a run seeded ``seed``."""
    return mix64((mix64(int(seed) & _M64) + int(row_index)) & _M64)


def generator_for_row(seed: int, row_index: int, device) -> torch.Generator:
    """A fresh generator of the row's own stream on ``device`` (the
    counterpart of ``key_for_row``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(row_seed(seed, row_index))
    return gen


def normal(gen: torch.Generator, shape) -> torch.Tensor:
    """One float32 standard-normal plane of ``shape`` on the generator's
    device."""
    return torch.randn(shape, generator=gen, device=gen.device)


def complex_normal(gen: torch.Generator, shape) -> tuple:
    """(re, im): two independent float32 standard-normal planes, the real
    and imaginary parts of JAX's complex gaussians."""
    return normal(gen, shape), normal(gen, shape)

"""Monte Carlo paths sharded over a mesh's ranks (counterpart:
``montecarlooptionspricer_tpu/parallel/sharded.py``).

Each rank draws its slice of the paths from a generator keyed by (seed,
rank), the counterpart of JAX's ``fold_in(key, axis_index)``, prices it,
and the means and regression moments all-reduce over the mesh's group
(every estimator takes ``group`` where JAX's take ``axis_name``).  Every
rank returns the same prices.
"""

from __future__ import annotations

import torch

from ..models import rough_volatility
from ..models.pricing import ESTIMATORS, PricerSpec, price_all
from ..ops.reductions import psum_if
from ..ops.rng import generator_for_row
from .mesh import Mesh


def _local_paths(mesh: Mesh, n_paths: int) -> int:
    if n_paths % mesh.size:
        raise ValueError(f"n_paths={n_paths} not divisible by mesh size "
                         f"{mesh.size}")
    return n_paths // mesh.size


def sharded_price_rbergomi(mesh: Mesh, spec: PricerSpec, s0, xi, h, eta,
                           rho, n_steps: int, n_paths: int):
    """A function seed -> {estimator: price} that draws ``n_paths``
    rBergomi paths split over the mesh's ranks and prices them together
    with the four estimators.  ``n_paths`` must divide by the mesh size.
    Rank r draws its paths, then its branch indices (among its own paths,
    as JAX's shards draw), from the generator of (seed, r), so a seed's
    prices repeat on a mesh of the same size."""
    local = _local_paths(mesh, n_paths)

    def run(seed: int) -> dict:
        gen = generator_for_row(seed, mesh.rank, mesh.device)
        paths = rough_volatility.generate_paths(
            gen, s0, xi, h, eta, rho, spec.r, n_steps, local, spec.dt)

        def branch_plane(b: int) -> torch.Tensor:
            del b      # the generator yields the branches in order
            return torch.randint(0, local, (1, local, n_steps),
                                 generator=gen, device=mesh.device)

        prices = price_all(paths[None], spec, branch_plane,
                           group=mesh.group)[0]
        return dict(zip(ESTIMATORS, prices.tolist()))

    return run


def sharded_mean_payoff(mesh: Mesh, payoff_fn, generate_fn, n_paths: int):
    """A function seed -> E[payoff_fn(paths)] over ``n_paths`` paths split
    over the mesh's ranks: rank r draws ``generate_fn(gen, n_paths /
    size)`` from the generator of (seed, r), and the ranks' means average
    over the group."""
    local = _local_paths(mesh, n_paths)

    def run(seed: int) -> float:
        gen = generator_for_row(seed, mesh.rank, mesh.device)
        val = torch.mean(payoff_fn(generate_fn(gen, local)))
        return float(psum_if(val, mesh.group)) / mesh.size

    return run

"""Process groups of the multi-device forms (counterpart:
``montecarlooptionspricer_tpu/parallel/mesh.py``).

JAX's mesh is single-controller: one process drives every device of a
1-D ``jax.sharding.Mesh`` and reduces across it with ``psum`` over an axis
name.  The port takes PyTorch's idiom instead: one process per device, all
of them ranks of one ``torch.distributed`` process group, NCCL on
``cuda`` and gloo on ``cpu`` (the tests').  A ``Mesh`` names the group,
this process's rank in it, the group's size and the rank's device.  A
``psum`` over the axis becomes an ``all_reduce`` (SUM) over the group
(``ops.reductions.psum_if``), and JAX's ``axis_name=None`` the port's
``group=None``: no collective, the one-device code as it is.

The two uses of JAX's mesh carry over:
  * paths: one option, each rank pricing its own chunks from a rank-offset
    stream, the pilot's regression moments and the chunk totals
    all-reduced (``parallel.sharded``, ``StreamingPricer(mesh=)``,
    ``StreamingChainPricer(mesh=)``);
  * rows: many options, each rank pricing its rows of a batch with no
    cross-rank reduction (``BatchedPricer(mesh=)``), or its rows of a
    training batch with the gradients all-reduced (``train_model(mesh=)``).

JAX's ``data_sharding`` and ``replicated`` place the shards of one global
array on the mesh's devices.  With one process per device there is no
global array to place: a rank holds its own shard (its rows, its chunks),
and a replicated value is one every rank computes from the same
all-reduced inputs.  So they have no counterpart here.

Nothing falls back: a failed NCCL initialization raises, a world smaller
than the mesh asked for raises, and no caller catches a collective's
failure.
"""

from __future__ import annotations

import atexit
import dataclasses
import logging
import os
import shutil
import tempfile
from typing import Any, Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# The variables torchrun sets for every rank it starts.
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh: the process ``group`` (the default
    group of the world), this process's ``rank`` in it, the group's
    ``size`` and the rank's ``device``."""

    group: Any
    rank: int
    size: int
    device: torch.device


def init_distributed(**kwargs) -> None:
    """``torch.distributed.init_process_group`` passthrough.

    Only a second initialization is tolerated (a no-op); every other
    failure (a bad address, a store that cannot be reached, a backend the
    build lacks) re-raises, because going on with one process would make
    each all-reduce cover a fraction of the paths and return wrong
    results."""
    try:
        dist.init_process_group(**kwargs)
    except (RuntimeError, ValueError) as e:
        msg = str(e).lower()
        if "twice" in msg or "already" in msg:
            return
        log.error("torch.distributed.init_process_group failed: %s", e)
        raise


def _private_store_dir() -> str:
    path = tempfile.mkdtemp(prefix="mcop_mesh_")
    atexit.register(shutil.rmtree, path, ignore_errors=True)
    return path


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The mesh of every rank of the world (default group), initialized
    here when no default group exists: from the launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, as torchrun sets them), or,
    without it and for ``n_devices`` None or 1, a world of one process on
    a private ``FileStore`` in a temporary directory (no network).

    Raises ValueError when the world has fewer ranks than ``n_devices``
    (JAX's message), or more: the port runs one process per device of the
    mesh.  On ``cuda`` rank r takes ``cuda:{LOCAL_RANK}`` and the group runs
    NCCL; a group of another backend raises.  One all-reduce over the group
    ends the call, so a communicator that cannot come up raises here, not
    at the first price."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a gloo "
                           "mesh on the host")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if all(k in os.environ for k in _LAUNCHER_ENV):
            init_distributed(backend=backend, init_method="env://")
        elif n_devices is None or n_devices == 1:
            store = dist.FileStore(
                os.path.join(_private_store_dir(), "store"), 1)
            init_distributed(backend=backend, store=store, rank=0,
                             world_size=1)
        else:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only 1 devices "
                "are available (start one process per device, e.g. with "
                "torchrun)")
    size = dist.get_world_size()
    if n_devices is not None and size < n_devices:
        raise ValueError(
            f"requested a {n_devices}-device mesh but only {size} devices "
            "are available")
    if n_devices is not None and size > n_devices:
        raise ValueError(
            f"requested a {n_devices}-device mesh in a world of {size} "
            "processes: the port runs one process per device of the mesh")
    if dist.get_backend() != backend:
        raise ValueError(
            f"the process group runs {dist.get_backend()}, a {device.type} "
            f"mesh needs {backend}")
    group = dist.group.WORLD
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe, group=group)
    if int(probe.item()) != size:
        raise RuntimeError(f"the mesh's probe all-reduce gave {probe.item()}"
                           f", not {size}")
    return Mesh(group, dist.get_rank(), size, device)


def mesh_device(mesh: Optional[Mesh], device) -> torch.device:
    """The device an entry point runs on: ``device``, or under ``mesh`` the
    mesh's device, which must be of ``device``'s type (no fallback)."""
    device = torch.device(device)
    if mesh is None:
        return device
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if mesh.device.type != device.type:
        raise ValueError(f"a {mesh.device.type} mesh cannot run on "
                         f"device {device}")
    return mesh.device

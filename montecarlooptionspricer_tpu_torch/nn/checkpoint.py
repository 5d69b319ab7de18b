"""Checkpoints and model files of the meta-model (counterpart:
``montecarlooptionspricer_tpu/nn/checkpoint.py``), as ``torch.save``
archives with a ``.pt`` suffix in place of JAX's flax msgpack.

A checkpoint holds the parameters, the optimizer's state (Adam's m, v and
count and the two finite-skip counters), the epoch, the loss and the
dropout generator's device type and state; a model file holds the
parameters.  Both are
written atomically: the bytes are fsynced before the rename, so a crash
leaves the previous archive whole.  Archives are read back with
``weights_only=True``: tensors, numbers and dicts, nothing executable.
"""

from __future__ import annotations

import io
import logging
import os
import pickle
import tempfile
from typing import Mapping, Optional, Tuple

import torch

log = logging.getLogger(__name__)

_SUFFIX = ".pt"


def _atomic_write(path: str, data: bytes) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".ckpt-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            # fsync before the rename: a journaled rename without durable
            # data could replace the last good archive with a truncated one
            # on power loss.
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _normalize(path: str) -> str:
    return path if path.endswith(_SUFFIX) else path + _SUFFIX


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def _dump(tree) -> bytes:
    buf = io.BytesIO()
    torch.save(_to_host(tree), buf)
    return buf.getvalue()


def _shapes(state: Mapping) -> dict:
    return {k: tuple(v.shape) for k, v in state.items()}


def save_checkpoint(path: str, params: Mapping, opt_state: Mapping,
                    epoch: int, loss: float, generator: Mapping) -> None:
    """Archive parameters, optimizer state, epoch, loss and the dropout
    generator (``{"device": device type, "state": Generator.get_state()}``),
    overwriting the previous checkpoint, so that a resumed run continues
    the dropout stream instead of replaying it."""
    tree = {"params": params, "opt_state": opt_state, "epoch": int(epoch),
            "loss": float(loss), "generator": dict(generator)}
    _atomic_write(_normalize(path), _dump(tree))


def load_checkpoint(path: str, params_template: Optional[Mapping] = None
                    ) -> Optional[Tuple[dict, dict, int, float, dict]]:
    """(params, opt_state, epoch, loss, generator) on the host; None when
    the file is absent or unreadable, or when its parameters' names and
    shapes differ from ``params_template``'s (the caller then trains from
    scratch).  The failure is logged."""
    path = _normalize(path)
    if not os.path.exists(path):
        return None
    try:
        tree = torch.load(path, map_location="cpu", weights_only=True)
        params, opt_state = tree["params"], tree["opt_state"]
        if params_template is not None and \
                _shapes(params) != _shapes(params_template):
            raise ValueError("its parameters do not fit the model")
        return (params, opt_state, int(tree["epoch"]), float(tree["loss"]),
                tree["generator"])
    except (OSError, RuntimeError, KeyError, TypeError, ValueError,
            EOFError, pickle.UnpicklingError) as e:
        log.error("Error loading checkpoint %s: %s", path, e)
        return None


def save_params(path: str, params: Mapping) -> None:
    """The final model file."""
    _atomic_write(_normalize(path), _dump({"params": params}))


def load_params(path: str) -> dict:
    """The parameters of a model file, on the host; raises when it is
    missing or unreadable."""
    return torch.load(_normalize(path), map_location="cpu",
                      weights_only=True)["params"]

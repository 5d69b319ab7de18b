"""The Bayesian meta-model (counterpart: ``montecarlooptionspricer_tpu/nn/
bnn.py``): a funnel MLP 512-256-128-64-32-16 with per-row normalization
and dropout on each of its first five layers, two live skip projections
(128->32, 64->32) into the fifth, a sigmoid gate on the 16-wide head, an
affine RealNVP flow and a mixture-density head of 5 means, 5 clamped
log-variances and 5 softmaxed weights.

The reference's quirks are kept, as the JAX package keeps them:
  * ``row_norm``: each row is normalized over its features (biased
    variance, eps 1e-5, no affine), what InstanceNorm1d does to a 2-D
    input.
  * The 4-head attention runs over the batch axis and its output is sliced
    away, so the forward does not call it: XLA drops the reference's as
    dead code under ``jit``, and here it would cost scores [4, B, B] a
    forward (``[S, 4, B, B]`` over MC draws), quadratic in the rows.
    ``full_topology=True`` keeps its module and parameters, which the L2
    term excludes and whose gradients are zeros, as in the reference.
  * The dead layers fcOut, fcSkip1 and fcSkip2 are not instantiated.
  * The mixture weights leave the model softmaxed; the losses softmax them
    again (``nn/trainer.py``).

Parameter names mirror flax's module names (``fc1`` ... ``fcMDN``,
``flow0.sLayer``, ``attn.in_proj``); ``params_from_flax`` carries a JAX
parameter tree into this module's ``state_dict``.  Dropout draws its keep
masks from an explicit ``torch.Generator`` (or takes them injected), never
from torch's global generator.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NORM_EPS = 1e-5
LOGVAR_MIN, LOGVAR_MAX = -10.0, 2.0
WIDTHS = (512, 256, 128, 64, 32, 16)
DROP_RATES = (0.3, 0.3, 0.2, 0.2, 0.1)
# The TorchLinear layers of the JAX model, each a flax ``Dense_0`` inside.
LINEAR_NAMES = ("fc1", "fc2", "fc3", "fc4", "fc5", "fc6", "fcSkip3",
                "fcSkip4", "fcGate", "fcMDN", "flow0.sLayer", "flow0.tLayer")
# Plain flax Dense layers of the attention.
ATTN_NAMES = ("attn.in_proj", "attn.out_proj")
# Standard deviation of a standard normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def torch_linear(fan_in: int, features: int,
                 generator: torch.Generator) -> nn.Linear:
    """A linear layer with the reference's init: weight normal with std
    sqrt(1 / (3 fan_in)) (kaiming normal, a = sqrt(5)), bias uniform in
    +-1/sqrt(fan_in)."""
    layer = nn.Linear(fan_in, features)
    with torch.no_grad():
        layer.weight.normal_(0.0, math.sqrt(1.0 / (3.0 * fan_in)),
                             generator=generator)
        bound = 1.0 / math.sqrt(fan_in)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


def lecun_linear(fan_in: int, features: int,
                 generator: torch.Generator) -> nn.Linear:
    """A linear layer with flax ``nn.Dense``'s default init: weight
    lecun-normal (a normal truncated to +-2 std, scaled to std
    sqrt(1 / fan_in)), bias zero."""
    layer = nn.Linear(fan_in, features)
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
        (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    with torch.no_grad():
        u = torch.rand(layer.weight.shape, generator=generator)
        z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
        layer.weight.copy_(z.clamp(-2.0, 2.0)
                           * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))
        layer.bias.zero_()
    return layer


def row_norm(x: torch.Tensor) -> torch.Tensor:
    """Each row normalized over its features: biased variance, eps 1e-5,
    no affine (a layer norm without weights, one op each way)."""
    return F.layer_norm(x, x.shape[-1:], eps=NORM_EPS)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def split_mdn(outputs: torch.Tensor, num_mixtures: int = 5):
    """(means, logvars, mix block) of the model's output.  The mix block
    is already softmaxed; the losses softmax it again."""
    return (outputs[..., :num_mixtures],
            outputs[..., num_mixtures:2 * num_mixtures],
            outputs[..., 2 * num_mixtures:])


class RealNVPFlow(nn.Module):
    """Affine flow z = x * exp(s(x)) + t(x); the log-det-Jacobian, which
    the reference discards, is not computed."""

    def __init__(self, dim: int, generator: torch.Generator):
        super().__init__()
        self.sLayer = torch_linear(dim, dim, generator)
        self.tLayer = torch_linear(dim, dim, generator)

    def forward(self, x):
        return x * torch.exp(self.sLayer(x)) + self.tLayer(x)


class BatchMultiheadAttention(nn.Module):
    """Self-attention across the batch axis (embed 128, 4 heads): the
    sequence axis is the row axis, so with a leading draw axis each draw
    attends over its own rows.  The model's forward does not call it (its
    output would be discarded)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 generator: torch.Generator):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj = lecun_linear(embed_dim, 3 * embed_dim, generator)
        self.out_proj = lecun_linear(embed_dim, embed_dim, generator)

    def forward(self, x):  # x: [..., rows, embed]
        d = self.embed_dim // self.num_heads
        q, k, v = self.in_proj(x).chunk(3, dim=-1)

        def heads(a):  # [..., rows, embed] -> [..., heads, rows, d]
            return a.unflatten(-1, (self.num_heads, d)).transpose(-3, -2)

        q, k, v = heads(q), heads(k), heads(v)
        scores = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(d)
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        return self.out_proj(out.transpose(-3, -2).flatten(-2))


class BayesianMetaModelNN(nn.Module):
    """The meta-model.  ``hidden_dim`` is accepted for the reference's
    constructor; the funnel widths are fixed.  The layers are initialized
    from ``generator``, in the order they are declared."""

    def __init__(self, input_dim: int = 17, hidden_dim: int = 64,
                 num_mixtures: int = 5, full_topology: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        h1, h2, h3, h4, h5, h6 = WIDTHS
        self.input_dim, self.hidden_dim = input_dim, hidden_dim
        self.num_mixtures, self.full_topology = num_mixtures, full_topology
        self.fc1 = torch_linear(input_dim, h1, generator)
        self.fc2 = torch_linear(h1, h2, generator)
        self.fc3 = torch_linear(h2, h3, generator)
        self.fc4 = torch_linear(h3, h4, generator)
        self.fc5 = torch_linear(h4, h5, generator)
        self.fcSkip3 = torch_linear(h3, h5, generator)
        self.fcSkip4 = torch_linear(h4, h5, generator)
        self.fc6 = torch_linear(h5, h6, generator)
        self.fcGate = torch_linear(h6, h6, generator)
        if full_topology:
            self.attn = BatchMultiheadAttention(h3, 4, generator)
        self.flow0 = RealNVPFlow(h6, generator)
        self.fcMDN = torch_linear(h6, 3 * num_mixtures, generator)

    @staticmethod
    def draw_masks(rows_shape: Sequence[int], generator: torch.Generator,
                   device) -> list:
        """The five keep masks of one train-mode forward over rows of shape
        ``rows_shape`` ([B] or [S, B]), from one uniform draw."""
        u = torch.rand((*rows_shape, sum(WIDTHS[:5])), generator=generator,
                       device=device)
        return [part < 1.0 - rate for part, rate in
                zip(u.split(WIDTHS[:5], dim=-1), DROP_RATES)]

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None,
                masks: Optional[Sequence[torch.Tensor]] = None):
        """Outputs [..., 3 * num_mixtures] for inputs [..., B, input_dim].
        ``train`` applies dropout with ``masks`` (five boolean keep masks,
        [..., B, width]) or, when none are given, masks drawn from
        ``generator``."""
        if train and masks is None:
            if generator is None:
                raise ValueError("a train-mode forward needs a generator "
                                 "or injected masks")
            masks = self.draw_masks(x.shape[:-1], generator, x.device)
        outs, h = [], x
        for i, fc in enumerate((self.fc1, self.fc2, self.fc3, self.fc4,
                                self.fc5)):
            h = F.relu(row_norm(fc(h)))
            if train:
                # The kept units scaled by 1 / keep, the others zeroed.
                h = h * (masks[i] * (1.0 / (1.0 - DROP_RATES[i])))
            outs.append(h)
        out5 = h + self.fcSkip3(outs[2]) + self.fcSkip4(outs[3])
        out6 = F.relu(self.fc6(out5))
        gated = out6 * torch.sigmoid(self.fcGate(out6))
        z = self.flow0(swish(gated))
        means, logvars, logits = self.fcMDN(z).split(self.num_mixtures,
                                                     dim=-1)
        return torch.cat([means, logvars.clamp(LOGVAR_MIN, LOGVAR_MAX),
                          torch.softmax(logits, dim=-1)], dim=-1)


def _flax_leaf(tree: Mapping, name: str) -> Mapping:
    """The flax sub-tree holding ``kernel`` and ``bias`` of the port's
    layer ``name`` (``fc1`` -> tree["fc1"]["Dense_0"],
    ``flow0.sLayer`` -> tree["flow0"]["sLayer"]["Dense_0"],
    ``attn.in_proj`` -> tree["attn"]["in_proj"])."""
    node = tree
    for part in name.split("."):
        node = node[part]
    return node if name in ATTN_NAMES else node["Dense_0"]


def params_from_flax(tree: Mapping) -> dict:
    """A JAX parameter tree (nested dicts of arrays, as
    ``jax.tree.map(np.asarray, trainer.params)`` gives it, or any tree of
    that structure such as its gradients) as this module's ``state_dict``:
    dense kernels [in, out] become weights [out, in].  The attention is
    carried when the tree has it."""
    names = LINEAR_NAMES + (ATTN_NAMES if "attn" in tree else ())
    state = {}
    for name in names:
        leaf = _flax_leaf(tree, name)
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(leaf["kernel"], np.float32).T))
        state[f"{name}.bias"] = torch.from_numpy(np.array(
            leaf["bias"], np.float32))
    return state

"""Training and prediction of the Bayesian meta-model (counterpart:
``montecarlooptionspricer_tpu/nn/trainer.py``), in plain PyTorch on the
card.

Training semantics, as the JAX package's:
  * Sequential, unshuffled batches; the last partial batch is padded with
    zero-weight rows, so each loss is a weighted mean over real rows.
  * Two loss phases: epochs up to ``warmup_epochs`` train on the MSE of the
    mean of the mixture means (``warmup_mse``), later ones on the mixture
    density's negative log-likelihood with the weights softmaxed a second
    time (``mdn_nll``); an L2 term over every parameter but the attention's
    (``l2_penalty``).
  * optax's ``apply_if_finite(chain(clip_by_global_norm(1.0), adam(lr)))``
    (``FiniteAdam``): gradients below the clip norm pass untouched, others
    are scaled by clip / norm; a non-finite gradient makes no update, leaves
    Adam's moments and count as they were and counts itself.  A batch with
    a non-finite loss stays out of the epoch's mean loss.
  * One host sync an epoch: the skip, the clip and the loss sums are tensor
    ops, and the epoch's mean loss is read once, after its last step (and
    under a mesh the ranks' SIGINT flag, once before it).
  * A checkpoint every epoch (parameters, optimizer state, epoch, loss and
    the dropout generator's device type and state), resumed at epoch + 1
    with the dropout stream continued, on the same device type only;
    SIGINT saves and returns.

Under a ``mesh`` (``parallel.mesh.Mesh``; counterpart: the JAX
``train_model(mesh=)``) each rank trains on its contiguous slice of every
batch's rows with the parameters replicated: the gradients and the data
loss are all-reduced (SUM) in one collective before ``FiniteAdam.step``,
so the finite flag and the clip norm are the global ones (a NaN on any
rank skips the step on every rank).  Each rank divides its loss by the
whole batch's weight sum, so a padded last batch, whose zero-weight rows
fall on the last ranks, weighs as on one device; each draws the whole
batch's dropout masks from the shared generator state and keeps its rows,
so a sharded epoch draws one device's masks and the generator stays in
step for a resume.  Rank 0 alone writes checkpoints.

Dropout draws from the trainer's own ``torch.Generator`` on the device,
seeded from ``TrainConfig.seed``; the weights are initialized from a CPU
generator seeded from it too, so a seed gives the same initial weights on
every device.
"""

from __future__ import annotations

import logging
import math
import signal
import time
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..ops.reductions import psum_if
from ..parallel.mesh import mesh_device
from . import checkpoint as ckpt_lib
from .bnn import BayesianMetaModelNN, split_mdn

log = logging.getLogger(__name__)

LOG_2PI = float(np.log(2.0 * np.pi))


def _wmean(per_row, w, wsum=None):
    """Mean over rows, or the mean over the rows ``w`` weighs 1 (the padded
    last batch's zero-weight rows drop out); ``wsum`` replaces the weight
    sum of ``w`` (a rank's shard divides by its whole batch's)."""
    if w is None:
        return per_row.mean()
    if wsum is None:
        wsum = w.sum().clamp_min(1.0)
    return (per_row * w).sum() / wsum


def mdn_nll(outputs, targets, num_mixtures: int = 5, w=None, wsum=None):
    """The mixture density's negative log-likelihood of ``targets``
    ([B, 1]), with the model's softmaxed weights softmaxed again."""
    means, logvars, mix_sm = split_mdn(outputs, num_mixtures)
    logvars = logvars.clamp(-10.0, 2.0)
    mix = torch.softmax(mix_sm, dim=-1)
    var = torch.exp(logvars) + 1e-6
    log_probs = -0.5 * ((means - targets).square() / var + logvars + LOG_2PI)
    joint = log_probs + torch.log(mix + 1e-6)
    return _wmean(-torch.logsumexp(joint, dim=-1), w, wsum)


def warmup_mse(outputs, targets, num_mixtures: int = 5, w=None, wsum=None):
    """The warm-up loss: MSE of the mean of the mixture means."""
    means, _, _ = split_mdn(outputs, num_mixtures)
    pred = means.mean(dim=-1, keepdim=True)
    return _wmean((pred - targets).square().mean(dim=-1), w, wsum)


def live_names(names: Sequence[str]) -> list:
    """The parameters the L2 term covers: all but the attention's, whose
    output is discarded (so they keep their initial values, as in the
    reference, instead of decaying)."""
    return [n for n in names if not n.startswith("attn.")]


def l2_penalty(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Sum of squares of the parameters ``live_names`` keeps."""
    live = [params[n] for n in live_names(list(params))]
    return torch.stack(torch._foreach_norm(live)).square().sum()


class FiniteAdam:
    """optax's ``apply_if_finite(chain(clip_by_global_norm(clip_norm),
    adam(lr)))`` on a list of parameters, updated in place, with no host
    sync.

    The gradients are copied into one flat buffer. If any is non-finite the
    update is zero, m, v and count stay, ``notfinite_count`` counts up and
    ``total_notfinite`` too; otherwise ``notfinite_count`` returns to 0,
    the gradients are clipped to the global norm (untouched below it,
    scaled by clip_norm / norm above) and Adam's update
    -lr * m_hat / (sqrt(v_hat) + eps) is added to the parameters.  (optax
    gives up skipping after ``max_consecutive_errors`` failures in a row;
    the JAX trainer sets that to 10**6, which this class treats as never.)
    """

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]],
                 lr: float, clip_norm: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.lr, self.clip_norm, self.b1, self.b2, self.eps = \
            lr, clip_norm, b1, b2, eps
        dev = self.params[0].device
        self._sizes = [p.numel() for p in self.params]
        n = sum(self._sizes)
        self.m = torch.zeros(n, device=dev)
        self.v = torch.zeros(n, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.total_notfinite = torch.zeros((), dtype=torch.int32, device=dev)
        self._grad = torch.zeros(n, device=dev)
        self._update = torch.zeros(n, device=dev)
        self._zero = torch.zeros((), device=dev)
        self._grad_views = self._views(self._grad)
        self._update_views = self._views(self._update)

    def _views(self, flat: torch.Tensor) -> list:
        return [t.view_as(p) for t, p in zip(flat.split(self._sizes),
                                             self.params)]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Apply one update from ``grads`` (aligned with the parameters);
        returns whether they were finite, as a 0-d bool tensor."""
        torch._foreach_copy_(self._grad_views, list(grads))
        g = self._grad
        ok = torch.isfinite(g).all()
        norm = torch.linalg.vector_norm(g)
        g = torch.where(norm < self.clip_norm, g,
                        g / norm * self.clip_norm)
        m = (1.0 - self.b1) * g + self.b1 * self.m
        v = (1.0 - self.b2) * g.square() + self.b2 * self.v
        count = self.count + 1
        t = count.to(torch.float32)
        m_hat = m / (1.0 - torch.pow(self.b1, t))
        v_hat = v / (1.0 - torch.pow(self.b2, t))
        update = m_hat / (torch.sqrt(v_hat) + self.eps) * (-self.lr)
        torch.where(ok, update, self._zero, out=self._update)
        self.m = torch.where(ok, m, self.m)
        self.v = torch.where(ok, v, self.v)
        self.count = torch.where(ok, count, self.count)
        self.total_notfinite = torch.where(ok, self.total_notfinite,
                                           self.total_notfinite + 1)
        self.notfinite_count = torch.where(ok, 0, self.notfinite_count + 1)
        torch._foreach_add_(self.params, self._update_views)
        return ok

    def state_dict(self) -> dict:
        return {"m": dict(zip(self.names, self._views(self.m.clone()))),
                "v": dict(zip(self.names, self._views(self.v.clone()))),
                "count": self.count.clone(),
                "notfinite_count": self.notfinite_count.clone(),
                "total_notfinite": self.total_notfinite.clone()}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        for key in ("m", "v"):
            flat = torch.cat([state[key][n].reshape(-1) for n in self.names])
            getattr(self, key).copy_(flat)
        for key in ("count", "notfinite_count", "total_notfinite"):
            getattr(self, key).copy_(state[key])


class BayesianTrainer:
    """Training manager of the meta-model on ``device`` (``cuda`` unless
    the caller asks for the CPU; there is no fallback)."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 config: Optional[TrainConfig] = None,
                 full_topology: bool = True, device="cuda"):
        self.config = config or TrainConfig(input_dim=input_dim,
                                            hidden_dim=hidden_dim)
        self.device = torch.device(device)
        init_seed, dropout_seed = (int(s) for s in np.random.SeedSequence(
            self.config.seed).generate_state(2))
        self.model = BayesianMetaModelNN(
            input_dim, hidden_dim, self.config.num_mixtures, full_topology,
            generator=torch.Generator().manual_seed(init_seed)
        ).to(self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(dropout_seed)
        self._named = list(self.model.named_parameters())
        self._params = [p for _, p in self._named]
        self._sizes = [p.numel() for p in self._params]
        live = set(live_names([n for n, _ in self._named]))
        self._live_idx = [i for i, (n, _) in enumerate(self._named)
                          if n in live]
        self.optimizer: Optional[FiniteAdam] = None
        self.current_epoch = 0
        self._stop_requested = False

    # -- one step ----------------------------------------------------------
    def _tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def loss_and_grads(self, x, y, w=None, *, warmup: bool, masks=None,
                       wsum=None, group=None):
        """(loss, grads) of one train-mode batch: the phase's data loss
        plus ``l2_lambda`` times ``l2_penalty``, and its gradients aligned
        with ``model.named_parameters()``.  The L2 term's gradient,
        2 * l2_lambda * p, is added to the data loss's in one foreach op.
        ``masks`` injects the dropout masks; otherwise they are drawn from
        the trainer's generator.  With a process ``group`` the rows are
        this rank's shard of a batch of weight sum ``wsum``: the data
        loss and its gradients are summed over the group's ranks in one
        all-reduce before the L2 term joins them."""
        cfg = self.config
        out = self.model(x, train=True, generator=self.generator,
                         masks=masks)
        loss_fn = warmup_mse if warmup else mdn_nll
        data = loss_fn(out, y, cfg.num_mixtures, w, wsum)
        # The attention's parameters get zeros, as from JAX's autodiff.
        grads = torch.autograd.grad(data, self._params, allow_unused=True,
                                    materialize_grads=True)
        if group is not None:
            flat = psum_if(torch.cat([g.reshape(-1) for g in grads]
                                     + [data.detach().reshape(1)]), group)
            grads = [t.view_as(p) for t, p in zip(
                flat.split(self._sizes + [1]), self._params)]
            data = flat[-1]
        with torch.no_grad():
            torch._foreach_add_([grads[i] for i in self._live_idx],
                                [self._params[i] for i in self._live_idx],
                                alpha=2.0 * cfg.l2_lambda)
            loss = data.detach() + cfg.l2_lambda * l2_penalty(
                dict(self._named))
        return loss, list(grads)

    def _make_optimizer(self, lr: float) -> None:
        if self.optimizer is None:
            self.optimizer = FiniteAdam(self._named, lr,
                                        self.config.grad_clip_norm)
        self.optimizer.lr = lr

    def _step(self, x, y, w, warmup: bool, mesh=None):
        """One optimizer step; (the loss where finite else 0, finite).
        Under ``mesh`` on this rank's slice of the batch's rows, with the
        whole batch's masks drawn and its weight sum."""
        if mesh is None:
            loss, grads = self.loss_and_grads(x, y, w, warmup=warmup)
        else:
            rows = x.shape[0]
            per = rows // mesh.size
            mine = slice(mesh.rank * per, (mesh.rank + 1) * per)
            masks = [m[mine] for m in self.model.draw_masks(
                (rows,), self.generator, x.device)]
            loss, grads = self.loss_and_grads(
                x[mine], y[mine], w[mine], warmup=warmup, masks=masks,
                wsum=w.sum().clamp_min(1.0), group=mesh.group)
        self.optimizer.step(grads)
        finite = torch.isfinite(loss)
        return torch.where(finite, loss, 0.0), finite

    def run_epoch(self, xb, yb, wb, warmup: bool, mesh=None) -> torch.Tensor:
        """One epoch over batches [n_batches, batch, ...] on the device, no
        host sync; the mean of the finite batches' losses, 0-d on the
        device.  Under ``mesh`` each rank steps on its rows of each batch
        (``_step``)."""
        total = torch.zeros((), device=self.device)
        count = torch.zeros((), device=self.device)
        for x, y, w in zip(xb.unbind(0), yb.unbind(0), wb.unbind(0)):
            loss, finite = self._step(x, y, w, warmup, mesh)
            total += loss
            count += finite
        return total / count.clamp_min(1.0)

    def batched(self, x, y, batch_size: int):
        """(xb, yb, wb) on the device: the rows padded to whole batches and
        reshaped to [n_batches, batch_size, ...], with a {0, 1} row weight
        marking the padding."""
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32).reshape(-1, 1)
        n = x.shape[0]
        n_batches = -(-n // batch_size)
        pad = n_batches * batch_size - n
        w = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
        xp = np.concatenate([x, np.zeros((pad, x.shape[1]), np.float32)])
        yp = np.concatenate([y, np.zeros((pad, 1), np.float32)])
        shape = (n_batches, batch_size)
        return (self._tensor(xp.reshape(shape + x.shape[1:])),
                self._tensor(yp.reshape(shape + (1,))),
                self._tensor(w.reshape(shape)))

    # -- checkpoints -------------------------------------------------------
    def _save_checkpoint(self, path: str, epoch: int, loss: float) -> None:
        ckpt_lib.save_checkpoint(path, self.model.state_dict(),
                                 self.optimizer.state_dict(), epoch, loss,
                                 {"device": self.device.type,
                                  "state": self.generator.get_state()})

    def _restore(self, path: str) -> Optional[Tuple[int, float]]:
        """Load the checkpoint at ``path`` into the model, the optimizer
        and the dropout generator; (epoch, loss), or None when there is
        none.  A checkpoint written on another device type is refused: its
        generator's stream (Philox on the card, Mersenne Twister on the
        CPU) cannot continue here, and restarting it would replay the first
        epoch's masks."""
        restored = ckpt_lib.load_checkpoint(path, self.model.state_dict())
        if restored is None:
            return None
        params, opt_state, epoch, loss, gen = restored
        if gen["device"] != self.device.type:
            raise ValueError(
                f"checkpoint {path} continues a dropout stream drawn on "
                f"{gen['device']}; resume it on {gen['device']} (--device "
                f"{gen['device']}) or train from scratch")
        self.model.load_state_dict(params)
        self.optimizer.load_state_dict(opt_state)
        self.generator.set_state(gen["state"])
        return epoch, loss

    # -- training loop -----------------------------------------------------
    def train_model(self, x, y, num_epochs: Optional[int] = None,
                    batch_size: Optional[int] = None,
                    lr: Optional[float] = None,
                    checkpoint_path: Optional[str] = None,
                    mesh=None) -> None:
        """Train from epoch 1, or from the checkpoint's epoch + 1 when
        ``checkpoint_path`` holds one, to ``num_epochs``.  With ``mesh``
        every rank calls it with the same arguments and trains on its rows
        of each batch (module docstring); ``batch_size`` must divide by the
        mesh size, and rank 0 alone writes the checkpoints."""
        cfg = self.config
        num_epochs = cfg.num_epochs if num_epochs is None else num_epochs
        batch_size = cfg.batch_size if batch_size is None else batch_size
        if mesh is not None:
            mesh_device(mesh, self.device)
            if batch_size % mesh.size:
                raise ValueError(f"batch_size={batch_size} not divisible by "
                                 f"mesh size {mesh.size}")
        writes = mesh is None or mesh.rank == 0
        lr = cfg.learning_rate if lr is None else lr
        if checkpoint_path is None:
            checkpoint_path = cfg.checkpoint_path
        self._make_optimizer(lr)
        xb, yb, wb = self.batched(x, y, batch_size)

        start_epoch, last_epoch_loss = 1, 0.0
        restored = self._restore(checkpoint_path)
        if restored is not None:
            epoch, last_epoch_loss = restored
            self.current_epoch = epoch
            start_epoch = epoch + 1
            log.info("Loaded checkpoint at epoch %d (loss %.6f)", epoch,
                     last_epoch_loss)
        else:
            log.info("No checkpoint found. Starting training from scratch.")

        self._stop_requested = False

        def _sigint(signum, frame):
            self._stop_requested = True

        prev_handler = None
        try:
            prev_handler = signal.signal(signal.SIGINT, _sigint)
        except ValueError:
            pass  # not on the main thread; the caller handles SIGINT

        def stop() -> bool:
            """The SIGINT flag, on any rank of the mesh."""
            if mesh is None:
                return self._stop_requested
            flag = torch.tensor([float(self._stop_requested)],
                                device=self.device)
            return bool(psum_if(flag, mesh.group).item() > 0)

        try:
            for epoch in range(start_epoch, num_epochs + 1):
                if stop():
                    log.info("Training interrupted. Saving checkpoint...")
                    if writes:
                        self._save_checkpoint(checkpoint_path, epoch - 1,
                                              last_epoch_loss)
                    return
                t0 = time.time()
                loss = self.run_epoch(xb, yb, wb,
                                      warmup=epoch <= cfg.warmup_epochs,
                                      mesh=mesh)
                epoch_loss = float(loss)              # one sync an epoch
                last_epoch_loss = epoch_loss
                self.current_epoch = epoch
                if writes:
                    self._save_checkpoint(checkpoint_path, epoch, epoch_loss)
                log.info("Epoch %d/%d | loss %.6f | %.2fs", epoch, num_epochs,
                         epoch_loss, time.time() - t0)
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGINT, prev_handler)

    # -- persistence -------------------------------------------------------
    def save_model(self, path: str) -> None:
        ckpt_lib.save_params(path, self.model.state_dict())

    def load_model(self, path: str) -> None:
        self.model.load_state_dict(ckpt_lib.load_params(path))

    # -- prediction --------------------------------------------------------
    @torch.no_grad()
    def forward(self, x) -> torch.Tensor:
        """The eval-mode outputs [B, 3 * num_mixtures] on the device."""
        return self.model(self._tensor(x))

    def meta_model_prediction(self, features, n_samples: int = 100,
                              stds: float = 3.0) -> Tuple[float, float,
                                                          float]:
        """MC-dropout prediction (mean, mean - stds * sigma,
        mean + stds * sigma) of the first mixture mean; with n_samples <= 1
        one eval forward and a degenerate interval."""
        x = np.asarray(features, np.float32).reshape(1, -1)
        if n_samples <= 1:
            val = float(self.forward(x)[0, 0])
            return val, val, val
        vals = self.predict_mc(x, n_samples)[:, 0]
        mean = float(vals.mean())
        var = float(vals.square().mean()) - mean * mean
        std = math.sqrt(var) if var > 0 else 0.0
        return mean, mean - stds * std, mean + stds * std

    @torch.no_grad()
    def aleatoric_std(self, x) -> torch.Tensor:
        """Per-row aleatoric std about the point estimate means[0]:
        sqrt(mixture variance + (mixture mean - means[0])^2) from one eval
        forward, with the double-softmaxed weights.  The reference's
        interval discards it; ``mcop-evaluate-nn-torch
        --calibrated-intervals`` adds it in quadrature."""
        means, logvars, mix_sm = split_mdn(self.model(self._tensor(x)),
                                           self.config.num_mixtures)
        w = torch.softmax(mix_sm, dim=-1)
        var_comp = torch.exp(logvars.clamp(-10.0, 2.0))
        mu_mix = (w * means).sum(dim=-1)
        var_mix = (w * (var_comp + means.square())).sum(dim=-1) \
            - mu_mix.square()
        return torch.sqrt((var_mix + (mu_mix - means[:, 0]).square())
                          .clamp_min(0.0))

    @torch.no_grad()
    def predict_mc(self, x, n_samples: int = 100) -> torch.Tensor:
        """[n_samples, B] train-mode draws of the first mixture mean, all
        draws in one batched forward, masks from the trainer's
        generator."""
        x = self._tensor(x)
        out = self.model(x.expand(n_samples, *x.shape), train=True,
                         generator=self.generator)
        return out[..., 0]

"""The port's Bayesian meta-model against the JAX package's on the CPU:
the same parameters (carried from one JAX trainer by ``params_from_flax``)
and the same inputs, made with numpy, through the eval forward, the
train-mode forward on injected dropout masks (JAX's through
``flax.linen.intercept_methods``), the losses, both loss phases' gradients
against jitted ``jax.value_and_grad``, the optimizer's updates against
optax's on identical gradients, the aleatoric std; then the port's init in
distribution and its batched MC draws (each draw's attention over its own
rows)."""

import math
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from montecarlooptionspricer_tpu.nn import bnn as jbnn
from montecarlooptionspricer_tpu.nn import trainer as jtr
from montecarlooptionspricer_tpu_torch.config import TrainConfig
from montecarlooptionspricer_tpu_torch.nn import bnn, trainer as ttr

ROWS = 16
FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
LOSS_RTOL = 1e-5
GRAD_SCALE_TOL = 1e-4      # of each leaf's max-abs
UPDATE_ATOL = 1e-6


@pytest.fixture(scope="module")
def jtrainer():
    """One JAX trainer, its model's init jitted for this test's speed (the
    same parameters as flax's eager init, in a third of its time)."""
    eager = jbnn.BayesianMetaModelNN.init

    def jitted(self, rngs, x, train=False):
        return jax.jit(lambda r, x: eager(self, r, x, train=train))(rngs, x)

    with mock.patch.object(jbnn.BayesianMetaModelNN, "init", jitted):
        return jtr.BayesianTrainer(17, 64)


@pytest.fixture(scope="module")
def jparams(jtrainer):
    return jax.tree.map(np.asarray, jtrainer.params)


def _slim(tree):
    return {k: v for k, v in tree.items() if k != "attn"}


def _port_trainer(jparams, full_topology=True):
    t = ttr.BayesianTrainer(17, 64, full_topology=full_topology,
                            device="cpu")
    t.model.load_state_dict(bnn.params_from_flax(
        jparams if full_topology else _slim(jparams)))
    return t


def _batch(seed=3, rows=ROWS):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, 17)).astype(np.float32)
    y = (1.0 + 0.5 * rng.standard_normal((rows, 1))).astype(np.float32)
    w = np.ones(rows, np.float32)
    w[-3:] = 0.0                    # a padded last batch's zero-weight rows
    masks = [rng.random((rows, width)) < 1.0 - rate
             for width, rate in zip(bnn.WIDTHS[:5], bnn.DROP_RATES)]
    return x, y, w, masks


def _jax_masked_apply(model, params, x, masks):
    """model.apply in train mode with each nn.Dropout replaced, in call
    order, by where(mask, x / keep, 0) on the injected masks."""
    it = iter(masks)

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and \
                context.method_name == "__call__":
            keep = 1.0 - context.module.rate
            return jnp.where(next(it), args[0] / keep, 0.0)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        return model.apply({"params": params}, x, train=True,
                           rngs={"dropout": jax.random.key(0)})


def _t(masks):
    return [torch.from_numpy(np.asarray(m)) for m in masks]


@pytest.mark.parametrize("full_topology", [True, False])
def test_eval_forward_matches_flax(jparams, full_topology):
    x, _, _, _ = _batch()
    jmodel = jbnn.BayesianMetaModelNN(17, 64, full_topology=full_topology)
    want = np.asarray(jax.jit(jmodel.apply)(
        {"params": jparams if full_topology else _slim(jparams)}, x))
    t = _port_trainer(jparams, full_topology)
    np.testing.assert_allclose(t.forward(x).numpy(), want, rtol=FWD_RTOL,
                               atol=FWD_ATOL)


def test_masked_train_forward_and_losses_match_flax(jparams):
    x, y, w, masks = _batch()
    jmodel = jbnn.BayesianMetaModelNN(17, 64)
    want = np.asarray(jax.jit(
        lambda p: _jax_masked_apply(jmodel, p, x, masks))(jparams))
    t = _port_trainer(jparams)
    with torch.no_grad():
        got = t.model(torch.from_numpy(x), train=True, masks=_t(masks))
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    # Dropout changed the outputs: the masks were applied on both sides.
    assert np.abs(want - t.forward(x).numpy()).max() > 1e-3

    out = torch.from_numpy(want.copy())
    for jloss, tloss in ((jtr.mdn_nll, ttr.mdn_nll),
                         (jtr.warmup_mse, ttr.warmup_mse)):
        for weights in (None, w):
            jw = None if weights is None else jnp.asarray(weights)
            tw = None if weights is None else torch.from_numpy(weights)
            assert float(tloss(out, torch.from_numpy(y), 5, tw)) == \
                pytest.approx(float(jloss(jnp.asarray(want), y, 5, jw)),
                              rel=LOSS_RTOL)
    state = bnn.params_from_flax(jparams)
    assert float(ttr.l2_penalty(state)) == pytest.approx(
        float(jtr.l2_penalty(jparams)), rel=LOSS_RTOL)
    # The penalty leaves the attention out.
    assert float(ttr.l2_penalty(state)) == pytest.approx(
        float(ttr.l2_penalty(bnn.params_from_flax(_slim(jparams)))),
        rel=1e-7)


@pytest.mark.parametrize("warmup", [True, False], ids=["warmup", "mdn"])
def test_gradients_match_jax_value_and_grad(jparams, warmup):
    """The full loss (data + l2 * penalty) and its gradient of every
    parameter, the attention's zeros included, in both loss phases."""
    x, y, w, masks = _batch(seed=5)
    jmodel = jbnn.BayesianMetaModelNN(17, 64)
    l2 = TrainConfig().l2_lambda

    @jax.jit
    def value_and_grad(p):
        def loss_fn(p):
            out = _jax_masked_apply(jmodel, p, x, masks)
            data = (jtr.warmup_mse if warmup else jtr.mdn_nll)(
                out, jnp.asarray(y), 5, w=jnp.asarray(w))
            return data + l2 * jtr.l2_penalty(p)
        return jax.value_and_grad(loss_fn)(p)

    jloss, jgrads = value_and_grad(jparams)
    t = _port_trainer(jparams)
    loss, grads = t.loss_and_grads(torch.from_numpy(x), torch.from_numpy(y),
                                   torch.from_numpy(w), warmup=warmup,
                                   masks=_t(masks))
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    want = bnn.params_from_flax(jax.tree.map(np.asarray, jgrads))
    names = [n for n, _ in t.model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        ref = want[name].numpy()
        scale = np.abs(ref).max()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=GRAD_SCALE_TOL * scale,
                                   err_msg=name)
        if name.startswith("attn."):
            assert scale == 0.0 and not g.any()
        else:
            assert scale > 0.0


def test_optimizer_matches_optax_apply_if_finite(jtrainer, jparams):
    """Three steps on identical gradients: one under the clip norm, one
    over it, one with a NaN (skipped: zero update, moments and count kept,
    both counters up), then a finite one again."""
    lr = 3e-4
    tx = jtrainer._make_tx(lr)
    jstate = tx.init(jparams)

    @jax.jit
    def jstep(g, state, p):
        updates, state = tx.update(g, state, p)
        return updates, state, optax.apply_updates(p, updates)

    jp = jparams
    t = _port_trainer(jparams)
    t._make_optimizer(lr)
    opt = t.optimizer
    rng = np.random.default_rng(11)
    base = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                        .astype(np.float32), jparams)
    norm = math.sqrt(sum(float((a ** 2).sum())
                         for a in jax.tree.leaves(base)))
    nan_tree = jax.tree.map(np.copy, base)
    nan_tree["fc3"]["Dense_0"]["kernel"][2, 5] = np.nan
    steps = [(jax.tree.map(lambda a: a * (0.5 / norm), base), True),
             (jax.tree.map(lambda a: a * (4.0 / norm), base), True),
             (nan_tree, False),
             (jax.tree.map(lambda a: a * (2.0 / norm), base), True)]
    names = opt.names
    for k, (g, finite) in enumerate(steps):
        updates, jstate, jp = jstep(g, jstate, jp)
        g_state = bnn.params_from_flax(g)
        ok = opt.step([g_state[n] for n in names])
        assert bool(ok) == finite
        got = dict(zip(names, opt._views(opt._update)))
        want = bnn.params_from_flax(jax.tree.map(np.asarray, updates))
        for n in names:
            np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                       rtol=0, atol=UPDATE_ATOL,
                                       err_msg=f"step {k} {n}")
        if not finite:
            assert not opt._update.any()
        params = bnn.params_from_flax(jax.tree.map(np.asarray, jp))
        for n, p in t.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), params[n].numpy(),
                                       rtol=0, atol=UPDATE_ATOL)
        adam = jstate.inner_state[1][0]
        assert int(opt.count) == int(adam.count)
        assert int(opt.notfinite_count) == int(jstate.notfinite_count)
        assert int(opt.total_notfinite) == int(jstate.total_notfinite)
        for key, jm in (("m", adam.mu), ("v", adam.nu)):
            mine = opt.state_dict()[key]
            ref = bnn.params_from_flax(jax.tree.map(np.asarray, jm))
            for n in names:
                np.testing.assert_allclose(mine[n].numpy(), ref[n].numpy(),
                                           rtol=1e-5, atol=1e-9)
    assert int(opt.count) == 3 and int(opt.total_notfinite) == 1


def test_aleatoric_std_and_split_mdn_match(jtrainer, jparams):
    x, _, _, _ = _batch(seed=9)
    t = _port_trainer(jparams)
    np.testing.assert_allclose(t.aleatoric_std(x).numpy(),
                               np.asarray(jtrainer.aleatoric_std(x)),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    out = np.random.default_rng(2).standard_normal((4, 15)).astype(
        np.float32)
    for got, want in zip(bnn.split_mdn(torch.from_numpy(out)),
                         jbnn.split_mdn(out)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # n_samples <= 1: one eval forward, a degenerate interval.
    m, lo, hi = t.meta_model_prediction(x[0], n_samples=1)
    jm, _, _ = jtrainer.meta_model_prediction(x[0], n_samples=1)
    assert m == lo == hi and m == pytest.approx(jm, rel=FWD_RTOL,
                                                abs=FWD_ATOL)


def test_init_in_distribution():
    """Each reference linear's weight std within 5 % of sqrt(1/(3 fan_in))
    (pooled over the small layers), biases inside +-1/sqrt(fan_in); the
    attention's lecun-normal weights within 5 % of sqrt(1/fan_in) and
    truncated at 2 std, its biases zero.  A seed gives the same weights
    on every call."""
    model = bnn.BayesianMetaModelNN(17, 64, generator=torch.Generator()
                                    .manual_seed(7))
    pooled = []
    for name in bnn.LINEAR_NAMES:
        layer = model.get_submodule(name)
        fan_in = layer.in_features
        w = layer.weight.detach().double() * math.sqrt(3.0 * fan_in)
        if w.numel() >= 4096:
            assert abs(float(w.std()) - 1.0) < 0.05, name
        else:
            pooled.append(w.reshape(-1))
        bound = 1.0 / math.sqrt(fan_in)
        b = float(layer.bias.detach().abs().max())
        assert 0.5 * bound < b <= bound, name
    assert abs(float(torch.cat(pooled).std()) - 1.0) < 0.05
    for name in bnn.ATTN_NAMES:
        layer = model.get_submodule(name)
        w = layer.weight.detach().double() * math.sqrt(layer.in_features)
        assert abs(float(w.std()) - 1.0) < 0.05, name
        assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 + 1e-6
        assert not layer.bias.any(), name
    again = bnn.BayesianMetaModelNN(17, 64, generator=torch.Generator()
                                    .manual_seed(7))
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), n


def test_forward_skips_the_dead_attention(jparams):
    """The attention's output is sliced away, so no forward (eval, train
    or over MC draws) calls it; its parameters still get zero gradients
    and stay out of the L2 term."""
    t = _port_trainer(jparams)

    def called(*args):
        raise AssertionError("the dead attention was computed")

    t.model.attn.register_forward_pre_hook(called)
    x, y, _, _ = _batch(seed=17, rows=6)
    t.forward(x)
    t.predict_mc(x, 3)
    _, grads = t.loss_and_grads(torch.from_numpy(x),
                                torch.from_numpy(y).reshape(-1, 1),
                                warmup=False)
    for (n, _), g in zip(t.model.named_parameters(), grads):
        if n.startswith("attn."):
            assert not g.any(), n


def test_mc_draws_attend_per_draw(jparams):
    """predict_mc's shape and spread; a [S, B] batch attends over each
    draw's rows (not over S * B rows), and each draw of the batched
    forward equals that draw's own forward on its masks."""
    x, _, _, _ = _batch(seed=13, rows=6)
    t = _port_trainer(jparams)
    draws = t.predict_mc(x, 12)
    assert draws.shape == (12, 6) and float(draws.std(dim=0).min()) > 0
    s = 3
    gen = torch.Generator().manual_seed(1)
    xs = torch.from_numpy(x).expand(s, *x.shape)
    masks = bnn.BayesianMetaModelNN.draw_masks((s, 6), gen, "cpu")
    with torch.no_grad():
        batched = t.model(xs, train=True, masks=masks)
        h = torch.randn(s, 6, 128, generator=gen)
        attn = t.model.attn(h)
        flat = t.model.attn(h.reshape(1, s * 6, 128)).reshape(s, 6, 128)
        for i in range(s):
            one = t.model(xs[i], train=True, masks=[m[i] for m in masks])
            torch.testing.assert_close(batched[i], one, rtol=1e-6,
                                       atol=1e-6)
            torch.testing.assert_close(attn[i], t.model.attn(h[i]),
                                       rtol=1e-6, atol=1e-6)
    assert float((attn - flat).abs().max()) > 1e-3

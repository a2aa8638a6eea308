"""The port's training slice against the JAX package on the CPU: the
diffusion loss and its parameter gradients, the optimizer, the Lt history,
the plateau scheduler, gradient accumulation and a short training run.

Tolerances:
  * losses rtol 1e-5: the same float32 formulas on both sides.
  * parameter gradients rtol 2e-3 / atol 1e-4 * max(1, max |JAX gradient|),
    that of tests/test_train_step.py (two layers of float32 reductions in
    another order, then the loss's softmaxes and logs).
  * optimizer updates rtol 1e-6: the same elementwise arithmetic.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from decompdiff_tpu.diffusion import categorical as jcat
from decompdiff_tpu.models.diffusion_model import DecompDiffModel as JaxModel
from decompdiff_tpu.training import train_step as jts
from decompdiff_tpu.utils.testing import (
    random_complex_batch as jax_random_complex_batch)
from decompdiff_tpu_torch.diffusion import categorical as tcat
from decompdiff_tpu_torch.models.diffusion_model import (
    DecompDiffModel, sample_time, sample_time_symmetric)
from decompdiff_tpu_torch.training.train_step import (
    Optimizer, PlateauScheduler, create_train_state, get_learning_rate,
    lt_update, make_eval_step, make_train_fns, set_learning_rate,
    weighted_loss)
from decompdiff_tpu_torch.utils.params import (
    flax_to_state_dict, load_flax_params, state_dict_to_flax)
from decompdiff_tpu_torch.utils.testing import (
    random_complex_batch, tiny_model_config)

torch.set_num_threads(2)
TRAIN_CFG = {
    'loss_weights': {'pos': 1.0, 'v': 100.0, 'bond': 100.0},
    'pos_noise_std': 0.1,
    'prior_noise_std': 0.5,
    'max_grad_norm': 8.0,
    'optimizer': {'lr': 5e-4, 'beta1': 0.95, 'beta2': 0.999},
}
T = 20
BATCH = dict(batch_size=4, num_protein=16, num_ligand=6, real_ligand=5)
TIME_STEP = np.array([0, 7, 12, 19])          # t = 0 runs the decoder NLL


def _cfg(**kw):
    return tiny_model_config(num_diffusion_timesteps=T, **kw)


def _noise(seed=3):
    rng = np.random.default_rng(seed)
    B, Nl = BATCH['batch_size'], BATCH['num_ligand']
    b = np.triu(rng.integers(0, 5, size=(B, Nl, Nl)), 1)
    return {'pos_noise': rng.normal(size=(B, Nl, 3)).astype(np.float32),
            'v_perturbed': rng.integers(0, 8, size=(B, Nl)).astype(np.int32),
            'b_perturbed': (b + b.transpose(0, 2, 1)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    """JAX dense losses and parameter gradients of the weighted loss, with
    its initial parameters (cached: one JAX run serves every port case)."""
    model = JaxModel.create(_cfg(), 8)
    batch = jax_random_complex_batch(np.random.default_rng(0), **BATCH)
    params = model.init_params(jax.random.PRNGKey(0), batch)
    w = TRAIN_CFG['loss_weights']

    def f(params):
        out = model.get_diffusion_loss(params, jax.random.PRNGKey(1), batch,
                                       time_step=jnp.asarray(TIME_STEP),
                                       noise_override=_noise())
        ls = out['losses']
        return sum(w[k] * ls[k] for k in ls), ls

    (_, losses), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    as_np = functools.partial(jax.tree.map, np.asarray)
    return as_np(params), {k: float(v) for k, v in losses.items()}, \
        as_np(grads)


def _port_model(params, **kw):
    model = DecompDiffModel.create(_cfg(**kw), 8, device='cpu')
    load_flax_params(model.denoiser, params)
    return model


@pytest.mark.parametrize('use_kernels', [False, True],
                         ids=['dense', 'kernels'])
def test_diffusion_loss_and_grads_match_jax(use_kernels):
    params, want_losses, want_grads = _jax_loss_and_grads()
    model = _port_model(params, use_pallas=use_kernels)
    batch = random_complex_batch(np.random.default_rng(0), device='cpu',
                                 **BATCH)
    over = {k: torch.as_tensor(v) for k, v in _noise().items()}
    out = model.get_diffusion_loss(batch, time_step=torch.as_tensor(TIME_STEP),
                                   noise_override=over)
    assert sorted(out['losses']) == sorted(want_losses)
    for k, v in out['losses'].items():
        np.testing.assert_allclose(v.item(), want_losses[k], rtol=1e-5,
                                   err_msg=k)
    loss = weighted_loss(out['losses'], TRAIN_CFG['loss_weights'])
    names = [n for n, _ in model.denoiser.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.denoiser.parameters()))
    got = flax_to_state_dict(state_dict_to_flax(dict(zip(names, grads))))
    want = flax_to_state_dict(want_grads)
    assert sorted(got) == sorted(want)
    for name in want:
        w = want[name].numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[name].numpy(), w, rtol=2e-3,
                                   atol=1e-4 * scale, err_msg=name)


def test_categorical_helpers_match_jax():
    rng = np.random.default_rng(4)
    lp = jax.nn.log_softmax(jnp.asarray(rng.normal(size=(3, 5, 8)),
                                        jnp.float32))
    lq = jax.nn.log_softmax(jnp.asarray(rng.normal(size=(3, 5, 8)),
                                        jnp.float32))
    tp, tq = (torch.as_tensor(np.array(a)) for a in (lp, lq))
    np.testing.assert_allclose(tcat.categorical_kl(tp, tq).numpy(),
                               np.asarray(jcat.categorical_kl(lp, lq)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tcat.log_categorical(tp, tq).numpy(),
                               np.asarray(jcat.log_categorical(lp, lq)),
                               rtol=1e-6, atol=1e-7)


def test_q_v_sample_and_time_sampling():
    """q_v_sample draws from q(v_t | v_0): at t = 0 it keeps v_0; symmetric
    t pairs each draw with its mirror; importance t follows the history once
    every timestep has more than 10 losses."""
    model = DecompDiffModel.create(_cfg(), 8, device='cpu')
    v0 = torch.randint(0, 8, (64,), generator=torch.Generator().manual_seed(0))
    log_v0 = tcat.index_to_log_onehot(v0, 8)
    g = torch.Generator().manual_seed(1)
    idx, log_vt = model.atom_diff.q_v_sample(log_v0, torch.zeros(64).long(), g)
    assert torch.equal(idx, v0)
    assert torch.equal(log_vt.argmax(-1), v0)
    t, pt = sample_time_symmetric(7, T, g, 'cpu')
    assert t.shape == (7,) and bool((t[:3] + t[4:7] == T - 1).all())
    assert torch.allclose(pt, torch.full((7,), 1.0 / T))
    hist, count = torch.zeros(T), torch.full((T,), 11.0)
    hist[5] = 1e6
    t, _ = sample_time(32, T, 'importance', hist, count, g, 'cpu')
    assert bool((t == 5).float().mean() > 0.9)
    count[3] = 10.0                                 # not ready: symmetric
    t, _ = sample_time(8, T, 'importance', hist, count, g, 'cpu')
    assert bool((t[:3] + t[5:] == T - 1).all())   # 5 draws, 3 mirrors


def _optax_chain(wd):
    cfg = dict(TRAIN_CFG['optimizer'], weight_decay=wd)
    return jts.make_optimizer(cfg, TRAIN_CFG['max_grad_norm'])


@pytest.mark.parametrize('wd', [0.0, 0.1], ids=['no_wd', 'wd'])
def test_optimizer_matches_optax(wd):
    """Clip at global norm 8 then Adam, for 3 steps; the first two gradients
    are above the clip norm, the third below it."""
    rng = np.random.default_rng(5)
    shapes = {'a': (4, 3), 'b': (7,), 'c': (2, 2, 2)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * sc).astype(np.float32)
              for k, s in shapes.items()} for sc in (5.0, 3.0, 0.5)]
    tx = _optax_chain(wd)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v)) for k, v in p0.items()}
    opt = Optimizer(tp, dict(TRAIN_CFG['optimizer'], weight_decay=wd))
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step({k: torch.as_tensor(v) for k, v in g.items()})
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_optimizer_type_and_lr():
    p = {'w': torch.nn.Parameter(torch.zeros(2))}
    with pytest.raises(NotImplementedError):
        Optimizer(p, {'type': 'sgd'})
    opt = Optimizer(p, {'lr': 1e-3})
    assert get_learning_rate(opt) == pytest.approx(1e-3)
    set_learning_rate(opt, 5e-4)
    assert get_learning_rate(opt) == pytest.approx(5e-4)


@pytest.mark.parametrize('case', ['patience', 'relative_threshold'])
def test_plateau_scheduler(case):
    """As tests/test_train_step.py holds the JAX package's scheduler."""
    if case == 'patience':
        sched = PlateauScheduler(factor=0.5, patience=1, min_lr=1e-6)
        lr = sched.step(1.0, 5e-4)     # best
        lr = sched.step(1.1, lr)       # bad 1
        assert lr == pytest.approx(5e-4)
        lr = sched.step(1.2, lr)       # bad 2 -> reduce
        assert lr == pytest.approx(2.5e-4)
        restored = PlateauScheduler()
        restored.load_state_dict(sched.state_dict())
        assert restored.state_dict() == sched.state_dict()
        return
    sched = PlateauScheduler(factor=0.5, patience=2, min_lr=1e-6)
    lr = sched.step(0.650000, 1e-3)
    lr = sched.step(0.649995, lr)      # sub-threshold dips count as bad
    lr = sched.step(0.649990, lr)
    assert lr == pytest.approx(1e-3)
    lr = sched.step(0.649985, lr)      # bad 3 > patience 2 -> reduce
    assert lr == pytest.approx(5e-4)
    lr = sched.step(0.60, lr)          # a real improvement resets
    assert sched.num_bad == 0 and sched.best == pytest.approx(0.60)


def test_lt_history_matches_jax():
    """The Lt EMA, fed the t and per-graph losses of the JAX package's own
    grad_step, against its apply_grads' history over two updates (the second
    one revisits timesteps)."""
    model = JaxModel.create(_cfg(), 8)
    batch = jax_random_complex_batch(np.random.default_rng(0), **BATCH)
    state, tx = jts.create_train_state(model, jax.random.PRNGKey(0), batch,
                                       TRAIN_CFG)
    _, grad_step, apply_grads = jts.make_train_fns(model, tx, TRAIN_CFG)
    port = DecompDiffModel.create(_cfg(), 8, device='cpu')
    pstate = create_train_state(port, TRAIN_CFG)
    for key in (2, 3):
        g, _, t_used, per_graph = grad_step(state, batch,
                                            jax.random.PRNGKey(key))
        state, _ = apply_grads(state, g, t_used, per_graph)
        lt_update(pstate, torch.as_tensor(np.array(t_used)),
                  torch.as_tensor(np.array(per_graph)))
    np.testing.assert_allclose(pstate.lt_history.numpy(),
                               np.asarray(state.lt_history), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_array_equal(pstate.lt_count.numpy(),
                                  np.asarray(state.lt_count))


def test_gradient_accumulation_matches_one_step():
    """grad_step twice on the same micro-batch and generator state, then
    apply_grads with n_acc_batch 2, equals one train_step."""
    params, _, _ = _jax_loss_and_grads()
    batch = random_complex_batch(np.random.default_rng(0), device='cpu',
                                 **BATCH)
    cfg = dict(TRAIN_CFG, n_acc_batch=2)
    models = [_port_model(params) for _ in range(2)]
    states = [create_train_state(m, cfg) for m in models]
    train_step, grad_step, apply_grads = make_train_fns(models[0], cfg)
    g = torch.Generator().manual_seed(9)
    g1, _, t1, p1 = grad_step(states[0], batch,
                              torch.Generator().set_state(g.get_state()))
    g2, _, t2, p2 = grad_step(states[0], batch,
                              torch.Generator().set_state(g.get_state()))
    gsum = {k: g1[k] + g2[k] for k in g1}
    norm = apply_grads(states[0], gsum, torch.cat([t1, t2]),
                       torch.cat([p1, p2]))
    one_step = make_train_fns(models[1], cfg)[0]
    metrics = one_step(states[1], batch, g)
    torch.testing.assert_close(norm, metrics['grad_norm'], rtol=1e-6,
                               atol=0.0)
    for (n, a), (_, b) in zip(models[0].denoiser.named_parameters(),
                              models[1].denoiser.named_parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=n)
    assert states[0].step == states[1].step == 1
    assert float(states[0].lt_count.sum()) == 2 * BATCH['batch_size']


def test_training_lowers_fixed_t_loss():
    """Twelve steps with kernels on (their plain versions on the CPU) lower
    the fixed-t evaluation loss, and every step's metrics are finite."""
    model = DecompDiffModel.create(_cfg(use_pallas=True), 8, device='cpu')
    batch = random_complex_batch(np.random.default_rng(0), batch_size=8,
                                 num_protein=16, num_ligand=6, device='cpu')
    state = create_train_state(model, TRAIN_CFG)
    step = make_train_fns(model, TRAIN_CFG)[0]
    eval_step = make_eval_step(model, TRAIN_CFG)
    before, v_recon, b_recon = eval_step(batch, 5,
                                         torch.Generator().manual_seed(0))
    assert v_recon.shape == (8, 6, 8) and b_recon.shape == (8, 6, 6, 5)
    g = torch.Generator().manual_seed(7)
    for _ in range(12):
        metrics = step(state, batch, g)
        assert all(np.isfinite(float(v)) for v in metrics.values())
    after, _, _ = eval_step(batch, 5, torch.Generator().manual_seed(0))
    assert float(after['loss']) < float(before['loss'])
    assert state.step == 12
    assert float(state.lt_count.sum()) == 12 * 8


def test_created_model_takes_gradients():
    """A created model's parameters take gradients; a denoiser call under
    torch.no_grad, as the sampler makes it, records no graph."""
    model = DecompDiffModel.create(_cfg(), 8, device='cpu')
    batch = random_complex_batch(np.random.default_rng(2), device='cpu',
                                 **BATCH)
    state = (batch.ligand_pos, batch.ligand_v, batch.bond_type,
             torch.as_tensor(TIME_STEP))
    with torch.no_grad():
        out = model.apply(batch, *state)
    assert all(v.grad_fn is None for v in out.values())
    out = model.apply(batch, *state)
    sum(v.sum() for v in out.values()).backward()
    params = list(model.denoiser.parameters())
    assert all(p.grad is not None for p in params)
    assert sum(int(p.grad.abs().sum() > 0) for p in params) > len(params) // 2


def test_importance_mode_trains():
    """With sample_time_method 'importance' the step runs (symmetric t until
    every timestep has more than 10 losses) and records every graph."""
    model = DecompDiffModel.create(_cfg(), 8, device='cpu')
    batch = random_complex_batch(np.random.default_rng(1), device='cpu',
                                 **BATCH)
    cfg = dict(TRAIN_CFG, sample_time_method='importance')
    state = create_train_state(model, cfg)
    step = make_train_fns(model, cfg)[0]
    g = torch.Generator().manual_seed(3)
    for _ in range(3):
        assert np.isfinite(float(step(state, batch, g)['loss']))
    assert float(state.lt_count.sum()) == 3 * BATCH['batch_size']

"""The port under `compute_dtype: bfloat16` against the JAX package's bf16
compute path, on the CPU.

Parameters: the port draws them (seed 0) and the bridge carries the same
float32 tree into flax, so one float32 tree drives both packages.

The JAX programs are compiled with XLA's excess precision off
(`xla_allow_excess_precision`). By default a jitted JAX program may keep a
bf16 intermediate in float32 inside a fusion, which moves the tiny model's
position loss by twice the option's own effect; without it the program
rounds where its jaxpr says, as the port does op by op.

Tolerances, each case also asserting that the port's bf16 result moves
from its own float32 result by more than its tolerance:
  * predictions (the option moves them by ~7e-3 on uni_o2_bond, ~1e-3 on
    uni_o2): uni_o2_bond rtol = atol = 2e-4 (measured 5e-6 dense, 7e-7
    kernels), with pallas_bf16 and pallas_gather_bf16 1e-3 (the
    pallas_bf16 tolerance of tests/test_torch_model.py: a y within float32
    rounding of a bf16 boundary rounds the other way in the two; measured
    3.5e-4); uni_o2 rtol = atol = 1e-4 (measured 7e-7). The bf16 result
    must move by more than 4 x atol.
  * losses rtol 1e-5 (measured 3e-7; the option moves them by 5e-5 to
    9e-4). Gradients as one vector: relative L2 error 6e-3 (measured
    3.8e-3 dense, 4.4e-3 kernels; the option moves them by 2.0e-2 and
    1.5e-2). They are computed in bf16, and the two frameworks round in
    different places: the order in which the cotangents of a bf16 tensor
    with many consumers are summed, and XLA's CPU reductions of bf16
    cotangents (the transposes of the bias broadcasts), which accumulate
    in bf16 where torch accumulates in float32. So single elements differ
    by the bf16 unit; the error concentrates in the first layers and the
    embeddings, where the most rounding has accumulated.
  * sampler positions rtol = atol = 2e-4 (measured 9e-6 after 3 truncated
    steps and 4.7e-5 after the driver's one strided step; the option moves
    them by 2e-3 and 6e-3), atom and bond types exactly equal (the draws
    are injected).
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import decompdiff_tpu.sampling.sampler as jax_sampler
from decompdiff_tpu.data.batch import ComplexBatch as JaxComplexBatch
from decompdiff_tpu.data.batch import FullProtein as JaxFullProtein
from decompdiff_tpu.models import common as jax_common
from decompdiff_tpu.models.diffusion_model import DecompDiffModel as JaxModel
from decompdiff_tpu.utils.testing import (
    random_complex_batch as jax_random_complex_batch)
from decompdiff_tpu_torch.data.batch import FullProtein
from decompdiff_tpu_torch.data.synthetic import write_synthetic_store
from decompdiff_tpu_torch.models import common
from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
from decompdiff_tpu_torch.sampling import driver
from decompdiff_tpu_torch.sampling.sampler import (
    SampleConfig, sample_diffusion)
from decompdiff_tpu_torch.training.train_step import weighted_loss
from decompdiff_tpu_torch.utils.params import (
    flax_to_state_dict, state_dict_to_flax)
from decompdiff_tpu_torch.utils.testing import (
    random_complex_batch, tiny_model_config)
from tests.test_torch_sampler import GUIDANCE, _sampler_case
from tests.test_torch_train import BATCH, TIME_STEP, TRAIN_CFG, _cfg, _noise

torch.set_num_threads(2)
BF16 = {'compute_dtype': 'bfloat16'}
BOND_TOL = dict(rtol=2e-4, atol=2e-4)
OPTIONS_TOL = dict(rtol=1e-3, atol=1e-3)
O2_TOL = dict(rtol=1e-4, atol=1e-4)
UNI_O2 = dict(model_type='uni_o2', bond_net_type='pre_att', ew_net_type='m')
OPTIONS = dict(pallas_bf16=True, pallas_gather_bf16=True)
# (config overrides, tolerance)
CASES = {
    'uni_o2_bond-dense': ({}, BOND_TOL),
    'uni_o2_bond-kernels': ({'use_pallas': True}, BOND_TOL),
    'uni_o2_bond-kernels-options': (dict(OPTIONS, use_pallas=True),
                                    OPTIONS_TOL),
    'uni_o2-dense': (UNI_O2, O2_TOL),
    'uni_o2-kernels': (dict(UNI_O2, use_pallas=True), O2_TOL),
}
LOSS_RTOL = 1e-5
GRAD_TOL = 6e-3
POS_TOL = dict(rtol=2e-4, atol=2e-4)
PRED_KEYS = ('pred_ligand_pos', 'pred_ligand_v', 'pred_bond')


def _exact(fn, *args):
    """fn(*args) jitted with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={'xla_allow_excess_precision': False})(*args)


def _models(cfg, seed=0):
    """The port's bf16 model of cfg and its float32 twin (same weights)."""
    f32 = DecompDiffModel.create(cfg, 8, device='cpu', seed=seed)
    bf16 = DecompDiffModel.create(dict(cfg, **BF16), 8, device='cpu')
    bf16.denoiser.load_state_dict(f32.denoiser.state_dict())
    return bf16, f32


@functools.lru_cache(maxsize=None)
def _jax_preds(case):
    """The JAX package's bf16 predictions of one case and the float32
    parameter tree they came from (the port's seed-0 draw)."""
    cfg = tiny_model_config(**CASES[case][0])
    params = state_dict_to_flax(_models(cfg)[1].denoiser.state_dict())
    jb = jax_random_complex_batch(np.random.default_rng(0))
    model = JaxModel.create(dict(cfg, **BF16), 8)
    preds = _exact(lambda p, b: model.apply(
        p, b, b.ligand_pos, b.ligand_v, b.bond_type, jnp.array([7, 31])),
        params, jb)
    return {k: np.asarray(v) for k, v in preds.items()}


@pytest.mark.parametrize('case', sorted(CASES))
def test_bf16_denoiser_matches_jax(case):
    """Port dense path against the JAX dense path, port kernel path (the
    kernels' plain versions on the CPU) against the JAX Pallas path in
    interpret mode, with the same float32 tree."""
    overrides, tol = CASES[case]
    bf16, f32 = _models(tiny_model_config(**overrides))
    assert bf16.denoiser.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf16.denoiser.parameters())
    batch = random_complex_batch(np.random.default_rng(0), device='cpu')
    args = (batch, batch.ligand_pos, batch.ligand_v, batch.bond_type,
            torch.tensor([7, 31]))
    with torch.no_grad():
        got, own32 = bf16.apply(*args), f32.apply(*args)
    want = _jax_preds(case)
    assert sorted(got) == sorted(want) == sorted(PRED_KEYS)
    for key in PRED_KEYS:
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), want[key], **tol,
                                   err_msg=key)
        moved = float((got[key] - own32[key]).abs().max())
        assert moved > 4 * tol['atol'], (key, moved)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(use_kernels):
    """JAX's bf16 losses and float32 parameter gradients of the weighted
    loss on tests/test_torch_train.py's batch and draws."""
    cfg = _cfg(use_pallas=use_kernels)
    params = state_dict_to_flax(_models(cfg)[1].denoiser.state_dict())
    model = JaxModel.create(dict(cfg, **BF16), 8)
    batch = jax_random_complex_batch(np.random.default_rng(0), **BATCH)
    w = TRAIN_CFG['loss_weights']

    def f(params):
        out = model.get_diffusion_loss(params, jax.random.PRNGKey(1), batch,
                                       time_step=jnp.asarray(TIME_STEP),
                                       noise_override=_noise())
        ls = out['losses']
        return sum(w[k] * ls[k] for k in ls), ls

    (_, losses), grads = _exact(jax.value_and_grad(f, has_aux=True), params)
    return ({k: float(v) for k, v in losses.items()},
            flax_to_state_dict(jax.tree.map(np.asarray, grads)))


def _port_loss_and_grads(model):
    batch = random_complex_batch(np.random.default_rng(0), device='cpu',
                                 **BATCH)
    over = {k: torch.as_tensor(v) for k, v in _noise().items()}
    out = model.get_diffusion_loss(batch, time_step=torch.as_tensor(TIME_STEP),
                                   noise_override=over)
    loss = weighted_loss(out['losses'], TRAIN_CFG['loss_weights'])
    names = [n for n, _ in model.denoiser.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.denoiser.parameters()))
    return ({k: v.item() for k, v in out['losses'].items()},
            flax_to_state_dict(state_dict_to_flax(dict(zip(names, grads)))))


def _rel_l2(a: dict, b: dict) -> float:
    """|a - b| / |b| over every gradient as one vector."""
    diff = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    norm = sum(float((b[k].double() ** 2).sum()) for k in b)
    return (diff / norm) ** 0.5


@pytest.mark.parametrize('use_kernels', [False, True],
                         ids=['dense', 'kernels'])
def test_bf16_loss_and_grads_match_jax(use_kernels):
    want_losses, want_grads = _jax_loss_and_grads(use_kernels)
    bf16, f32 = _models(_cfg(use_pallas=use_kernels))
    losses, grads = _port_loss_and_grads(bf16)
    losses32, grads32 = _port_loss_and_grads(f32)
    assert sorted(losses) == sorted(want_losses)
    for k, v in losses.items():
        np.testing.assert_allclose(v, want_losses[k], rtol=LOSS_RTOL,
                                   err_msg=k)
        assert abs(v - losses32[k]) > LOSS_RTOL * abs(v), k
    assert sorted(grads) == sorted(want_grads)
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads.values())
    assert _rel_l2(grads, want_grads) <= GRAD_TOL
    assert _rel_l2(grads, grads32) > GRAD_TOL


def _jax_sample(cfg, scfg, params, batch, init, full, noise):
    """JAX's sampler (its jitted scan) with excess precision off."""
    model = JaxModel.create(cfg, 8)
    full = JaxFullProtein(jnp.asarray(full),
                          jnp.ones(np.shape(full)[:2], bool))
    dyn = (params, jax.random.PRNGKey(0), batch,
           *(jnp.asarray(init[k]) for k in ('pos', 'v', 'bond')), full,
           {k: jnp.asarray(v) for k, v in noise.items()})
    out = jax_sampler._sample_jit.lower(model, scfg, *dyn).compile(
        compiler_options={'xla_allow_excess_precision': False})(*dyn)
    return {k: np.asarray(out[k]) for k in ('pos', 'v', 'bond')}


def _check_samples(got, want, own32):
    np.testing.assert_array_equal(got['v'], want['v'])
    np.testing.assert_array_equal(got['bond'], want['bond'])
    np.testing.assert_allclose(got['pos'], want['pos'], **POS_TOL)
    assert np.abs(got['pos'] - own32['pos']).max() > POS_TOL['atol']


def test_bf16_sampler_matches_jax():
    """Three guided truncated steps of the kernel path with injected draws
    against the JAX sampler's Pallas path."""
    steps = 3
    cfg, model, params, batch, jbatch, init, noise, full = _sampler_case(
        steps)
    cfg = dict(cfg, use_pallas=True)
    bf16, f32 = _models(cfg)
    for m in (bf16, f32):
        m.denoiser.load_state_dict(model.denoiser.state_dict())
    scfg = dict(num_steps=steps, skip_mode='truncate', energy_drift=GUIDANCE,
                save_traj=False)
    fp = FullProtein(torch.as_tensor(full),
                     torch.ones(full.shape[:2], dtype=torch.bool))
    got, own32 = ({k: v.numpy() for k, v in sample_diffusion(
        m, SampleConfig(**scfg), batch,
        *(torch.as_tensor(init[k]) for k in ('pos', 'v', 'bond')), fp,
        noise_override=noise).items()} for m in (bf16, f32))
    want = _jax_sample(dict(cfg, **BF16), jax_sampler.SampleConfig(**scfg),
                       params, jbatch, init, full, noise)
    _check_samples(got, want, own32)


def test_bf16_checkpoint_through_sampling_driver(tmp_path, monkeypatch):
    """A .ckpt whose config sets the key, through the sampling driver on
    the CPU: the model it builds computes in bf16, and its sampler call
    (the driver's batch, initial state and full protein, with injected
    draws) agrees with the JAX sampler on the same inputs. One strided
    step (t = 19 straight to the clean endpoint): a second step amplifies
    a bf16 flip of the first (4.7e-5 on one atom) to 1.5e-3 over a whole
    molecule, while the option moves it by 5e-2."""
    store = str(tmp_path / 'synth.ddstore')
    write_synthetic_store(store, [{}], seed=0)
    cfg = tiny_model_config(num_diffusion_timesteps=20, **BF16)
    f32 = DecompDiffModel.create(dict(cfg, compute_dtype='float32'), 8,
                                 device='cpu', seed=0)
    params = state_dict_to_flax(f32.denoiser.state_dict())
    ckpt = str(tmp_path / 'model.ckpt')
    with open(ckpt, 'wb') as f:
        pickle.dump({'config': {'data': {'transform': {
                         'ligand_atom_mode': 'basic'}}, 'model': cfg},
                     'params': params, 'step': 0, 'iteration': 0}, f,
                    protocol=4)
    yml = tmp_path / 'sample.yml'
    yml.write_text(f'data:\n  path: {store}\nsample:\n  seed: 2021\n'
                   '  num_samples: 2\n  num_steps: 1\n  skip_mode: strided\n'
                   '  sample_num_atoms: ref\n  energy_drift:\n'
                   '    - {type: clash, sigma: 2, gamma: 4}\n')
    calls = []
    orig = driver.sample_diffusion

    def sample(model, scfg, batch, init_pos, init_v, init_bond,
               full_protein=None, generator=None):
        S, (B, Nl) = scfg.num_steps, init_v.shape
        K, Kb = model.atom_diff.num_classes, model.bond_diff.num_classes
        rng = np.random.default_rng(7)
        noise = dict(pos_eps=rng.normal(size=(S, B, Nl, 3)),
                     v_uniform=rng.random((S, B, Nl, K)),
                     b_uniform=rng.random((S, B, Nl, Nl, Kb)))
        noise = {k: v.astype(np.float32) for k, v in noise.items()}
        out = orig(model, scfg, batch, init_pos, init_v, init_bond,
                   full_protein, noise_override=noise)
        own32 = orig(f32, scfg, batch, init_pos, init_v, init_bond,
                     full_protein, noise_override=noise)
        calls.append((model, scfg, batch, (init_pos, init_v, init_bond),
                      full_protein, noise, out, own32))
        return out

    monkeypatch.setattr(driver, 'sample_diffusion', sample)
    driver.main([str(yml), '--ckpt', ckpt, '-i', '0', '--outdir',
                 str(tmp_path / 'out'), '--batch_size', '2', '--device',
                 'cpu', '--recon_with_bond', 'false'])
    assert len(calls) == 1
    model, scfg, batch, init, full, noise, out, own32 = calls[0]
    assert model.denoiser.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.denoiser.parameters())
    assert full.mask.all()
    jbatch = JaxComplexBatch(**{k: jnp.asarray(getattr(batch, k).numpy())
                                for k in vars(batch)
                                if getattr(batch, k) is not None})
    want = _jax_sample(cfg, jax_sampler.SampleConfig(
        num_steps=scfg.num_steps, skip_mode=scfg.skip_mode,
        energy_drift=scfg.energy_drift, save_traj=False), params, jbatch,
        dict(zip(('pos', 'v', 'bond'), (t.numpy() for t in init))),
        full.pos.numpy(), noise)
    _check_samples({k: out[k].numpy() for k in want}, want,
                   {k: own32[k].numpy() for k in want})


# ---------------------------------------------------------------------------
# flax's compute-dtype semantics, module by module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [None, 'bfloat16'])
@pytest.mark.parametrize('x_dtype', ['float32', 'bfloat16'])
def test_dense_layernorm_mlp_follow_flax(dtype, x_dtype):
    """Dense, LayerNorm and MLP against flax's with the same dtype, on
    float32 and bf16 inputs: the same output dtype and, up to float32
    reduction order, the same values (bitwise for the bf16 results)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 7, 24)).astype(np.float32)
    jx = jnp.asarray(x).astype(x_dtype)
    tx = torch.as_tensor(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, x_dtype))
    jdt = None if dtype is None else jnp.bfloat16
    tdt = None if dtype is None else torch.bfloat16
    for flax_mod, port_mod in (
            (nn.Dense(16, dtype=jdt), common.Dense(24, 16, dtype=tdt)),
            (nn.LayerNorm(epsilon=1e-5, dtype=jdt),
             common.LayerNorm(24, dtype=tdt)),
            (jax_common.MLP(16, 32, dtype=jdt),
             common.MLP(24, 16, 32, dtype=tdt))):
        params = flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
        state = flax_to_state_dict(jax.tree.map(np.asarray, params))
        port_mod.load_state_dict({k.removeprefix('params.'): v
                                  for k, v in state.items()})
        want = flax_mod.apply(params, jx)
        with torch.no_grad():
            got = port_mod(tx)
        assert str(got.dtype).removeprefix('torch.') == str(want.dtype)
        w = np.asarray(want.astype(jnp.float32))
        tol = 0 if got.dtype == torch.bfloat16 and isinstance(
            port_mod, common.Dense) else 1e-6
        np.testing.assert_allclose(got.float().numpy(), w, rtol=tol,
                                   atol=tol, err_msg=type(port_mod).__name__)


def test_bf16_sigmoid_follows_jax():
    """jax.nn.sigmoid on bf16 (1 / (1 + exp(-x)), each step rounded):
    at most 0.1% of the results one bf16 unit apart (torch's and XLA's exp
    differ in the last float32 bits), while torch.sigmoid, which rounds
    once, differs on a third."""
    x = np.random.default_rng(0).normal(size=20000).astype(np.float32) * 3
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax.nn.sigmoid(jx).astype(jnp.float32))
    tx = torch.as_tensor(np.array(jx.astype(jnp.float32))).bfloat16()
    got = common.sigmoid(tx).float().numpy()
    once = torch.sigmoid(tx).float().numpy()
    assert (got != want).mean() <= 1e-3
    assert np.abs(got - want).max() <= 2 ** -8
    assert (once != want).mean() > 0.2
    torch.testing.assert_close(common.sigmoid(tx.float()),
                               torch.sigmoid(tx.float()), rtol=0, atol=0)


def test_compute_dtype_values():
    """The JAX package's three spellings are taken; any other is refused
    (JAX raises a KeyError on it)."""
    for value, want in ((None, None), ('float32', None),
                        ('bfloat16', torch.bfloat16)):
        model = DecompDiffModel.create(tiny_model_config(compute_dtype=value),
                                       8, device='cpu')
        assert model.denoiser.compute_dtype == want
    with pytest.raises(ValueError, match='compute_dtype'):
        DecompDiffModel.create(tiny_model_config(compute_dtype='float16'), 8,
                               device='cpu')


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def test_remat_refused_on_uni_o2_bond_ignored_on_uni_o2():
    with pytest.raises(NotImplementedError, match='remat'):
        DecompDiffModel.create(tiny_model_config(remat=True), 8,
                               device='cpu')
    batch = random_complex_batch(np.random.default_rng(0), device='cpu')
    preds = []
    for remat in (False, True):
        model = DecompDiffModel.create(tiny_model_config(remat=remat,
                                                         **UNI_O2),
                                       8, device='cpu', seed=0)
        with torch.no_grad():
            preds.append(model.apply(batch, batch.ligand_pos,
                                     batch.ligand_v, batch.bond_type,
                                     torch.tensor([7, 31])))
    for key in preds[0]:
        assert torch.equal(preds[0][key], preds[1][key]), key


@pytest.mark.parametrize('use_pallas,error', [
    (False, IndexError), (True, jax.errors.UnexpectedTracerError)],
    ids=['dense', 'kernels'])
def test_jax_remat_fails_on_uni_o2_bond(use_pallas, error):
    """The reference the port's refusal stands on: the JAX package cannot
    apply uni_o2_bond with remat: true (once it can, the refusal in
    models/denoiser.py should go)."""
    cfg = tiny_model_config(use_pallas=use_pallas)
    params = state_dict_to_flax(_models(cfg)[1].denoiser.state_dict())
    jb = jax_random_complex_batch(np.random.default_rng(0))
    with pytest.raises(error):
        JaxModel.create(dict(cfg, remat=True), 8).apply(
            params, jb, jb.ligand_pos, jb.ligand_v, jb.bond_type,
            jnp.array([7, 31]))

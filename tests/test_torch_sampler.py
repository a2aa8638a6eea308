"""The port's guidance energies and reverse-diffusion sampler against the
JAX package, on the same numpy inputs and the same injected noise.

Tolerances:
  * energies and their gradients: rtol 1e-5 / atol 1e-6. Both sides run
    the same float32 formulas; min selections pick the same pairs on
    tie-free coordinates.
  * sampler positions: rtol 1e-4 / atol 1e-5 on coordinates of a few to
    ten Angstrom. Each step adds the denoiser's float32 reduction-order
    differences (~1e-6) to the posterior mean, and the next step's guidance
    gradient and network see the perturbed coordinates.
  * atom and bond types: exactly equal (the Gumbel draws are injected).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decompdiff_tpu.data.batch import FullProtein as JaxFullProtein
from decompdiff_tpu.guidance import funcs as jfuncs
from decompdiff_tpu.models.diffusion_model import DecompDiffModel as JaxModel
from decompdiff_tpu.sampling import sampler as jsampler
from decompdiff_tpu.utils.testing import (
    random_complex_batch as jax_random_complex_batch)
from decompdiff_tpu_torch.data.batch import FullProtein
from decompdiff_tpu_torch.guidance import funcs as tfuncs
from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
from decompdiff_tpu_torch.sampling.sampler import (
    SampleConfig, sample_diffusion)
from decompdiff_tpu_torch.utils.params import state_dict_to_flax
from decompdiff_tpu_torch.utils.testing import (
    random_complex_batch, tiny_model_config)

torch.set_num_threads(2)
ENERGY_TOL = dict(rtol=1e-5, atol=1e-6)
POS_TOL = dict(rtol=1e-4, atol=1e-5)
NUM_CLASSES, NUM_BOND = 8, 5
GUIDANCE = ({'type': 'armsca_prox', 'min_d': 1.2, 'max_d': 1.9},
            {'type': 'clash', 'sigma': 2.0, 'gamma': 4.0})


# --------------------------------------------------------------------------
# guidance energies
# --------------------------------------------------------------------------

def _energy_inputs():
    kw = dict(batch_size=3, num_protein=16, num_ligand=9, num_groups=5,
              real_ligand=8)
    jb = jax_random_complex_batch(np.random.default_rng(11), **kw)
    tb = random_complex_batch(np.random.default_rng(11), device='cpu', **kw)
    full = (np.random.default_rng(12).normal(size=(3, 25, 3)) * 3
            ).astype(np.float32)
    full_mask = np.ones((3, 25), bool)
    full_mask[1, 20:] = False
    return jb, tb, full, full_mask


ENERGIES = {
    'center_prox': (
        lambda f, b, x, fp, fm: f.center_prox_energy(
            x, b.atom_prior_centers(), b.ligand_mask)),
    'armsca_prox': (
        lambda f, b, x, fp, fm: f.armsca_prox_energy(
            x, b.ligand_decomp_idx, b.num_arms, b.ligand_mask,
            b.num_groups, min_d=1.2, max_d=1.9)),
    'clash': (
        lambda f, b, x, fp, fm: f.clash_energy(
            fp, fm, x * 2.0, b.ligand_mask, sigma=2.0, surface_ct=4.0)),
    'arms_repul': (
        lambda f, b, x, fp, fm: f.arms_repul_energy(
            x, b.ligand_decomp_idx, b.num_arms, b.ligand_mask,
            b.num_groups, max_d=1.9)),
}


@pytest.mark.parametrize('name', sorted(ENERGIES))
def test_energy_and_gradient_match_jax(name):
    jb, tb, full, full_mask = _energy_inputs()
    energy = ENERGIES[name]

    def jax_energy(x):
        return energy(jfuncs, jb, x, jnp.asarray(full), jnp.asarray(full_mask))

    want, want_grad = jax.value_and_grad(jax_energy)(jb.ligand_pos)
    x = tb.ligand_pos.clone().requires_grad_(True)
    got = energy(tfuncs, tb, x, torch.as_tensor(full),
                 torch.as_tensor(full_mask))
    (grad,) = torch.autograd.grad(got, x)
    assert float(want) != 0.0                 # the energy is active here
    np.testing.assert_allclose(got.item(), float(want), **ENERGY_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               **ENERGY_TOL)


# --------------------------------------------------------------------------
# sampler
# --------------------------------------------------------------------------

def _sampler_case(steps, seed=0):
    cfg = tiny_model_config()
    model = DecompDiffModel.create(cfg, NUM_CLASSES, device='cpu', seed=seed)
    params = state_dict_to_flax(model.denoiser.state_dict())
    kw = dict(real_ligand=9, real_protein=22)
    batch = random_complex_batch(np.random.default_rng(seed), device='cpu',
                                 **kw)
    jbatch = jax_random_complex_batch(np.random.default_rng(seed), **kw)
    rng = np.random.default_rng(seed + 100)
    B, Nl = batch.batch_size, batch.num_ligand_atoms
    centers = batch.atom_prior_centers().numpy()
    stds = batch.atom_prior_stds().numpy()
    init = dict(
        pos=(centers + stds * rng.normal(size=centers.shape)
             ).astype(np.float32),
        v=rng.integers(0, NUM_CLASSES, size=(B, Nl)).astype(np.int32),
        bond=np.where(batch.bond_mask.numpy(),
                      rng.integers(0, NUM_BOND, size=(B, Nl, Nl)),
                      0).astype(np.int32))
    noise = dict(
        pos_eps=rng.normal(size=(steps, B, Nl, 3)).astype(np.float32),
        v_uniform=rng.random((steps, B, Nl, NUM_CLASSES)).astype(np.float32),
        b_uniform=rng.random((steps, B, Nl, Nl, NUM_BOND)
                             ).astype(np.float32))
    full = (rng.normal(size=(B, 30, 3)) * 4).astype(np.float32)
    return cfg, model, params, batch, jbatch, init, noise, full


@pytest.mark.parametrize('mode,steps,drift', [
    ('truncate', 3, GUIDANCE),
    ('strided', 2, GUIDANCE),
    ('truncate', 3, ({'type': 'center_prox'},
                     {'type': 'clash', 'sigma': 2.0, 'gamma': 4.0,
                      'scale': True})),
], ids=['truncate', 'strided', 'truncate-scaled'])
def test_sampler_matches_jax(mode, steps, drift):
    cfg, model, params, batch, jbatch, init, noise, full = _sampler_case(
        steps)
    full_mask = np.ones(full.shape[:2], bool)
    scfg = dict(num_steps=steps, skip_mode=mode, energy_drift=drift,
                save_traj=True)
    want = jsampler.sample_diffusion(
        JaxModel.create(cfg, NUM_CLASSES), jsampler.SampleConfig(**scfg),
        params, jax.random.PRNGKey(0), jbatch, jnp.asarray(init['pos']),
        jnp.asarray(init['v']), jnp.asarray(init['bond']),
        full_protein=JaxFullProtein(jnp.asarray(full), jnp.asarray(full_mask)),
        noise_override={k: jnp.asarray(v) for k, v in noise.items()})
    got = sample_diffusion(
        model, SampleConfig(**scfg), batch, torch.as_tensor(init['pos']),
        torch.as_tensor(init['v']), torch.as_tensor(init['bond']),
        FullProtein(torch.as_tensor(full), torch.as_tensor(full_mask)),
        noise_override=noise)

    np.testing.assert_array_equal(got['v'].numpy(), np.asarray(want['v']))
    np.testing.assert_array_equal(got['bond'].numpy(),
                                  np.asarray(want['bond']))
    np.testing.assert_allclose(got['pos'].numpy(), np.asarray(want['pos']),
                               **POS_TOL)
    assert sorted(got['traj']) == sorted(want['traj'])
    for key in ('v', 'bond'):
        np.testing.assert_array_equal(got['traj'][key].numpy(),
                                      np.asarray(want['traj'][key]))
    np.testing.assert_allclose(got['traj']['pos'].numpy(),
                               np.asarray(want['traj']['pos']), **POS_TOL)
    # the positions moved, and guidance was part of the move
    assert not np.allclose(got['pos'].numpy(), init['pos'])


def test_sampler_generator_path_and_refusals():
    cfg, model, _, batch, _, init, _, full = _sampler_case(2)
    args = (batch, torch.as_tensor(init['pos']), torch.as_tensor(init['v']),
            torch.as_tensor(init['bond']))
    fp = FullProtein(torch.as_tensor(full),
                     torch.ones(full.shape[:2], dtype=torch.bool))
    scfg = SampleConfig(num_steps=2, energy_drift=GUIDANCE, save_traj=False)
    outs = [sample_diffusion(model, scfg, *args, fp,
                             generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    for key in ('pos', 'v', 'bond'):              # one seed, one result
        assert torch.equal(outs[0][key], outs[1][key])
    assert torch.isfinite(outs[0]['pos']).all()
    assert 'traj' not in outs[0]
    with pytest.raises(ValueError, match='full_protein'):
        sample_diffusion(model, scfg, *args)

"""The port's uni_o2 slice against the JAX package on the CPU: the refine net
(UniTransformerO2) against the JAX dense path and the JAX Pallas path in
interpret mode, its gradients against jax.grad, and the uni_o2 denoiser,
diffusion loss and sampler steps, with the same parameters loaded through
the param bridge. With use_kernels on, the port's wrappers run their plain
versions here (CPU tensors).

Tolerances:
  * refine net and tiny denoiser: rtol 2e-4 / atol 2e-5, that of the JAX
    package's Pallas-vs-dense tests; both sides run float32, only the order
    of reductions differs.
  * gradients: rtol 2e-3 / atol 2e-4 * max(1, max |JAX gradient|), that of
    tests/test_pallas_uni_o2.py (two layers of float32 reductions in another
    order, then their backward).
  * losses rtol 1e-5 and their parameter gradients rtol 2e-3 / atol 1e-4 *
    max(1, max |JAX gradient|), as tests/test_torch_train.py.
  * sampler: types exact (the draws are injected), positions rtol 1e-4 /
    atol 1e-5, as tests/test_torch_sampler.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decompdiff_tpu.data.batch import FullProtein as JaxFullProtein
from decompdiff_tpu.models.diffusion_model import DecompDiffModel as JaxModel
from decompdiff_tpu.models.uni_transformer import (
    UniTransformerO2 as JaxUniTransformerO2)
from decompdiff_tpu.sampling import sampler as jsampler
from decompdiff_tpu.utils.testing import (
    random_complex_batch as jax_random_complex_batch)
from decompdiff_tpu_torch.data.batch import FullProtein
from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
from decompdiff_tpu_torch.models.uni_transformer import UniTransformerO2
from decompdiff_tpu_torch.ops import edge_attention as edge_ops
from decompdiff_tpu_torch.sampling.sampler import (
    SampleConfig, sample_diffusion)
from decompdiff_tpu_torch.utils.params import (
    flax_to_state_dict, load_flax_params, state_dict_to_flax)
from decompdiff_tpu_torch.utils.testing import (
    random_complex_batch, tiny_model_config, uni_o2_model_config)

torch.set_num_threads(2)
NET_TOL = dict(rtol=2e-4, atol=2e-5)
H, HEADS, K = 32, 4, 4

NET_CASES = {
    'global': dict(ew_net_type='global'),
    'r': dict(ew_net_type='r'),
    'none': dict(ew_net_type='none'),
    'm': dict(ew_net_type='m'),
    'r-x2h2-h2x2': dict(ew_net_type='r', num_x2h=2, num_h2x=2),
    'm-sync_twoup': dict(ew_net_type='m', sync_twoup=True),
    'global-radius': dict(ew_net_type='global', cutoff_mode='radius',
                          r_max=4.0),
}


def _net_inputs(B=2, Np=10, Nl=6, seed=0):
    """The inputs of tests/test_pallas_uni_o2.py: a ragged ligand (complex
    0 has 4 real ligand atoms), protein first."""
    rng = np.random.default_rng(seed)
    N = Np + Nl
    h = rng.normal(size=(B, N, H)).astype(np.float32)
    x = (rng.normal(size=(B, N, 3)) * 3).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[0, Np + 4:] = False
    mask_ligand = (np.arange(N)[None, :] >= Np) & mask
    return (h, x, mask, mask_ligand, mask_ligand.copy()), Np


def _jax_net(use_pallas, **kw):
    return JaxUniTransformerO2(num_blocks=1, num_layers=2, hidden_dim=H,
                               n_heads=HEADS, k=K, use_pallas=use_pallas, **kw)


def _port_net(params, **kw):
    net = UniTransformerO2(1, 2, H, HEADS, K, use_kernels=True, **kw)
    load_flax_params(net, params)
    return net


def _perturbed_params(net, args, Np, seed):
    """The net's flax init with every leaf moved by N(0, 0.1^2), so biases,
    LayerNorm parameters and the gates' biases are not at their init."""
    params = net.init(jax.random.PRNGKey(0), *args, num_protein=Np)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(
            np.float32), params)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize('case', sorted(NET_CASES))
def test_uni_o2_net_matches_jax(case):
    kw = NET_CASES[case]
    args, Np = _net_inputs(seed=sorted(NET_CASES).index(case))
    params = _perturbed_params(_jax_net(False, **kw), args, Np, seed=1)
    port = _port_net(params, **kw)
    gated = edge_ops.edge_attention.gated_launches
    with torch.no_grad():
        got = port(*map(_t, args), num_protein=Np)
    assert edge_ops.edge_attention.gated_launches == gated  # CPU: no launch
    for use_pallas in (False, True):
        want = _jax_net(use_pallas, **kw).apply(params, *args, num_protein=Np)
        for key in ('x', 'h'):
            np.testing.assert_allclose(
                got[key].numpy(), np.asarray(want[key]), **NET_TOL,
                err_msg=f'{key} (pallas={use_pallas})')


@pytest.mark.parametrize('ew', ['r', 'm'])
def test_uni_o2_net_grads_match_jax(ew):
    args, Np = _net_inputs(seed=7)
    h, x, mask, mask_ligand, movable = args
    rng = np.random.default_rng(9)
    cot_h = rng.normal(size=h.shape).astype(np.float32)
    cot_x = rng.normal(size=x.shape).astype(np.float32)
    params = _perturbed_params(_jax_net(False, ew_net_type=ew), args, Np,
                               seed=2)

    port = _port_net(params, ew_net_type=ew)
    th, tx = _t(h).requires_grad_(True), _t(x).requires_grad_(True)
    out = port(th, tx, *map(_t, (mask, mask_ligand, movable)), num_protein=Np)
    loss = (out['h'] * _t(cot_h)).sum() + (out['x'] * _t(cot_x)).sum()
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()) + [th, tx])
    got = dict(zip(names, grads[:-2]))
    got.update(h=grads[-2], x=grads[-1])

    for use_pallas in (False, True):
        net = _jax_net(use_pallas, ew_net_type=ew)

        def f(params, h, x):
            o = net.apply(params, h, x, mask, mask_ligand, movable,
                          num_protein=Np)
            return jnp.sum(o['h'] * cot_h) + jnp.sum(o['x'] * cot_x)
        gp, gh, gx = jax.grad(f, argnums=(0, 1, 2))(params, h, x)
        want = flax_to_state_dict(jax.tree.map(np.asarray, gp))
        assert sorted(want) == sorted(names)
        want.update(h=np.asarray(gh), x=np.asarray(gx))
        for name, w in want.items():
            w = np.asarray(w)
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(
                got[name].numpy(), w, rtol=2e-3, atol=2e-4 * scale,
                err_msg=f'{name} (pallas={use_pallas})')


# --------------------------------------------------------------------------
# denoiser, loss and sampler
# --------------------------------------------------------------------------

DENOISER_VARIANTS = {
    'pre_att': dict(bond_diffusion=True, bond_net_type='pre_att',
                    ew_net_type='m'),
    'no_bond': dict(bond_diffusion=False, ew_net_type='global'),
    'prior_node': dict(bond_diffusion=True, bond_net_type='pre_att',
                       ew_net_type='r', add_prior_node=True),
}


def _cfg(variant, **kw):
    return tiny_model_config(model_type='uni_o2', num_diffusion_timesteps=20,
                             **DENOISER_VARIANTS[variant], **kw)


@functools.lru_cache(maxsize=None)
def _jax_denoiser(variant):
    """Parameters of the tiny uni_o2 denoiser, and its JAX predictions on
    the dense path (use_pallas False) and the Pallas path in interpret mode
    (True)."""
    batch = jax_random_complex_batch(np.random.default_rng(0))
    params = jax.tree.map(np.asarray, JaxModel.create(_cfg(variant), 8)
                          .init_params(jax.random.PRNGKey(0), batch))
    preds = {}
    for use_pallas in (False, True):
        model = JaxModel.create(_cfg(variant, use_pallas=use_pallas), 8)
        out = model.apply(params, batch, batch.ligand_pos, batch.ligand_v,
                          batch.bond_type, jnp.array([7, 15]))
        preds[use_pallas] = {k: np.asarray(v) for k, v in out.items()}
    return params, preds


@pytest.mark.parametrize('use_kernels', [False, True],
                         ids=['dense', 'kernels'])
@pytest.mark.parametrize('variant', sorted(DENOISER_VARIANTS))
def test_uni_o2_denoiser_matches_jax(variant, use_kernels):
    params, preds = _jax_denoiser(variant)
    model = DecompDiffModel.create(_cfg(variant, use_pallas=use_kernels), 8,
                                   device='cpu')
    assert set(model.denoiser.state_dict()) == set(flax_to_state_dict(params))
    load_flax_params(model.denoiser, params)
    batch = random_complex_batch(np.random.default_rng(0), device='cpu')
    with torch.no_grad():
        got = model.apply(batch, batch.ligand_pos, batch.ligand_v,
                          batch.bond_type, torch.tensor([7, 15]))
    for use_pallas, want in preds.items():
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(
                got[key].numpy(), want[key], **NET_TOL,
                err_msg=f'{key} (pallas={use_pallas})')


def test_uni_o2_state_dict_keys_are_flax_paths():
    """Every parameter of the released-width uni_o2 model, and nothing
    else, is a flax path of the JAX model; no bond embedding exists."""
    cfg = uni_o2_model_config(num_layers=1)
    port = DecompDiffModel.create(cfg, 8, device='cpu', seed=0)
    batch = jax_random_complex_batch(np.random.default_rng(0), batch_size=1,
                                     num_protein=40, num_ligand=5)
    shapes = jax.eval_shape(JaxModel.create(cfg, 8).init_params,
                            jax.random.PRNGKey(0), batch)
    want = {'.'.join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                shapes['params'])}
    got = {k: tuple(v.shape) for k, v in port.denoiser.state_dict().items()}
    assert got == want
    assert 'refine_net.layer_0.x2h_0.ew_kernel' in got
    assert not any(k.startswith('ligand_bond_emb') for k in got)


def test_uni_o2_config_refusals():
    """bond_net_type 'lin' needs the bond stream, as the JAX package's
    assert says; an unknown ew_net_type is refused."""
    with pytest.raises(ValueError, match='lin'):
        DecompDiffModel.create(tiny_model_config(
            model_type='uni_o2', bond_diffusion=True, bond_net_type='lin'), 8,
            device='cpu')
    with pytest.raises(ValueError, match='ew_net_type'):
        DecompDiffModel.create(tiny_model_config(
            model_type='uni_o2', ew_net_type='x'), 8, device='cpu')


LOSS_BATCH = dict(batch_size=4, num_protein=16, num_ligand=6, real_ligand=5)


def _loss_noise(bond_diffusion, seed=3):
    rng = np.random.default_rng(seed)
    B, Nl = LOSS_BATCH['batch_size'], LOSS_BATCH['num_ligand']
    noise = {'pos_noise': rng.normal(size=(B, Nl, 3)).astype(np.float32),
             'v_perturbed': rng.integers(0, 8, size=(B, Nl)).astype(np.int32)}
    if bond_diffusion:
        b = np.triu(rng.integers(0, 5, size=(B, Nl, Nl)), 1)
        noise['b_perturbed'] = (b + b.transpose(0, 2, 1)).astype(np.int32)
    return noise


@pytest.mark.parametrize('variant', ['pre_att', 'no_bond'])
def test_uni_o2_loss_and_grads_match_jax(variant):
    cfg = _cfg(variant)
    bond = cfg['bond_diffusion']
    time_step = np.array([0, 7, 12, 19])         # t = 0 runs the decoder NLL
    model = JaxModel.create(cfg, 8)
    jbatch = jax_random_complex_batch(np.random.default_rng(0), **LOSS_BATCH)
    params = jax.tree.map(np.asarray,
                          model.init_params(jax.random.PRNGKey(0), jbatch))

    def f(params):
        out = model.get_diffusion_loss(
            params, jax.random.PRNGKey(1), jbatch,
            time_step=jnp.asarray(time_step),
            noise_override=_loss_noise(bond))
        ls = out['losses']
        return sum(ls.values()), ls

    (_, want_losses), want_grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params)

    port = DecompDiffModel.create(cfg, 8, device='cpu')
    load_flax_params(port.denoiser, params)
    batch = random_complex_batch(np.random.default_rng(0), device='cpu',
                                 **LOSS_BATCH)
    out = port.get_diffusion_loss(
        batch, time_step=torch.as_tensor(time_step),
        noise_override={k: torch.as_tensor(v)
                        for k, v in _loss_noise(bond).items()})
    assert sorted(out['losses']) == sorted(want_losses)
    for key, value in out['losses'].items():
        np.testing.assert_allclose(value.item(), float(want_losses[key]),
                                   rtol=1e-5, err_msg=key)
    names = [n for n, _ in port.denoiser.named_parameters()]
    grads = torch.autograd.grad(sum(out['losses'].values()),
                                list(port.denoiser.parameters()))
    want = flax_to_state_dict(jax.tree.map(np.asarray, want_grads))
    assert sorted(want) == sorted(names)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-3,
                                   atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize('variant', ['pre_att', 'no_bond'])
def test_uni_o2_sampler_matches_jax(variant):
    """Three guided truncate steps with injected noise."""
    steps, n_cls, n_bond = 3, 8, 5
    cfg = _cfg(variant)
    port = DecompDiffModel.create(cfg, n_cls, device='cpu', seed=0)
    params = state_dict_to_flax(port.denoiser.state_dict())
    kw = dict(real_ligand=9, real_protein=22)
    batch = random_complex_batch(np.random.default_rng(0), device='cpu',
                                 **kw)
    jbatch = jax_random_complex_batch(np.random.default_rng(0), **kw)
    rng = np.random.default_rng(100)
    B, Nl = batch.batch_size, batch.num_ligand_atoms
    centers = batch.atom_prior_centers().numpy()
    stds = batch.atom_prior_stds().numpy()
    init = dict(
        pos=(centers + stds * rng.normal(size=centers.shape)
             ).astype(np.float32),
        v=rng.integers(0, n_cls, size=(B, Nl)).astype(np.int32),
        bond=np.where(batch.bond_mask.numpy(),
                      rng.integers(0, n_bond, size=(B, Nl, Nl)),
                      0).astype(np.int32))
    noise = dict(
        pos_eps=rng.normal(size=(steps, B, Nl, 3)).astype(np.float32),
        v_uniform=rng.random((steps, B, Nl, n_cls)).astype(np.float32),
        b_uniform=rng.random((steps, B, Nl, Nl, n_bond)).astype(np.float32))
    full = (rng.normal(size=(B, 30, 3)) * 4).astype(np.float32)
    full_mask = np.ones(full.shape[:2], bool)
    scfg = dict(num_steps=steps, energy_drift=(
        {'type': 'armsca_prox', 'min_d': 1.2, 'max_d': 1.9},
        {'type': 'clash', 'sigma': 2.0, 'gamma': 4.0}))

    want = jsampler.sample_diffusion(
        JaxModel.create(cfg, n_cls), jsampler.SampleConfig(**scfg), params,
        jax.random.PRNGKey(0), jbatch, jnp.asarray(init['pos']),
        jnp.asarray(init['v']), jnp.asarray(init['bond']),
        full_protein=JaxFullProtein(jnp.asarray(full),
                                    jnp.asarray(full_mask)),
        noise_override={k: jnp.asarray(v) for k, v in noise.items()})
    got = sample_diffusion(
        port, SampleConfig(**scfg), batch, torch.as_tensor(init['pos']),
        torch.as_tensor(init['v']), torch.as_tensor(init['bond']),
        FullProtein(torch.as_tensor(full), torch.as_tensor(full_mask)),
        noise_override=noise)
    np.testing.assert_array_equal(got['v'].numpy(), np.asarray(want['v']))
    np.testing.assert_array_equal(got['bond'].numpy(),
                                  np.asarray(want['bond']))
    np.testing.assert_allclose(got['pos'].numpy(), np.asarray(want['pos']),
                               rtol=1e-4, atol=1e-5)
    assert not np.allclose(got['pos'].numpy(), init['pos'])

"""The port's whole denoiser against the JAX package's dense path, with the
parameters of JAX `init_params` loaded through the param bridge.

Tolerances:
  * tiny config (2 layers, H=32): rtol 2e-4 / atol 2e-5, that of the JAX
    package's own Pallas-vs-dense tests. Both sides run the same float32
    formulas; only the order of reductions differs (observed max abs error
    ~1e-6 on outputs of order one).
  * released width (6 layers, H=128, 16 heads, k=32): rtol 1e-3 / atol 1e-4.
    Six layers of 128-wide float32 sums with residual streams of growing
    magnitude compound the reduction-order differences.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decompdiff_tpu.models.diffusion_model import (
    DecompDiffModel as JaxModel, center_by_protein as jax_center_by_protein)
from decompdiff_tpu.utils.testing import (
    random_complex_batch as jax_random_complex_batch)
from decompdiff_tpu_torch.models.diffusion_model import (
    DecompDiffModel, center_by_protein)
from decompdiff_tpu_torch.utils.params import (
    flax_to_state_dict, load_flax_params, state_dict_to_flax)
from decompdiff_tpu_torch.utils.testing import (
    DEFAULT_MODEL_CONFIG, random_complex_batch, tiny_model_config)

torch.set_num_threads(2)
TINY_TOL = dict(rtol=2e-4, atol=2e-5)
RELEASED_TOL = dict(rtol=1e-3, atol=1e-4)
PRED_KEYS = ('pred_ligand_pos', 'pred_ligand_v', 'pred_bond')

VARIANTS = {
    'released': {},
    'prior_node': {'add_prior_node': True},            # 6 edge types
    'pre_att_sin_time': {'bond_net_type': 'pre_att', 'time_emb_dim': 4,
                         'time_emb_mode': 'sin'},
    'radius': {'cutoff_mode': 'radius', 'r_max': 3.0},
}


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _jax_reference(variant):
    """JAX dense predictions and parameters for one tiny config (cached:
    each config's JAX run serves both of the port's paths)."""
    cfg = tiny_model_config(**VARIANTS[variant])
    model = JaxModel.create(cfg, 8)
    batch = jax_random_complex_batch(np.random.default_rng(0))
    params = model.init_params(jax.random.PRNGKey(0), batch)
    t = jnp.array([7, 31])
    preds = model.apply(params, batch, batch.ligand_pos, batch.ligand_v,
                        batch.bond_type, t)
    return cfg, _numpy_tree(params), {k: np.asarray(v) for k, v in
                                      preds.items()}


def _port_preds(cfg, params, batch, t):
    model = DecompDiffModel.create(cfg, 8, device='cpu')
    load_flax_params(model.denoiser, params)
    with torch.no_grad():
        return model.apply(batch, batch.ligand_pos, batch.ligand_v,
                           batch.bond_type, t)


@pytest.mark.parametrize('use_kernels', [False, True],
                         ids=['dense', 'kernels'])
@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_tiny_denoiser_matches_jax(variant, use_kernels):
    cfg, params, want = _jax_reference(variant)
    batch = random_complex_batch(np.random.default_rng(0), device='cpu')
    got = _port_preds(dict(cfg, use_pallas=use_kernels), params, batch,
                      torch.tensor([7, 31]))
    assert sorted(got) == sorted(PRED_KEYS)
    for key in PRED_KEYS:
        np.testing.assert_allclose(got[key].numpy(), want[key], **TINY_TOL,
                                   err_msg=key)


def test_released_width_forward_matches_jax():
    """Released width and depth (H=128, 6 layers, 16 heads, k=32), forward
    only, at B=1, Np=48, Nl=12. The port draws the weights (JAX's eager
    init at this width costs half a minute) and the bridge carries them
    back into a flax tree for the JAX dense path."""
    cfg = dict(DEFAULT_MODEL_CONFIG)
    kw = dict(batch_size=1, num_protein=48, num_ligand=12)
    init = DecompDiffModel.create(cfg, 8, device='cpu', seed=1)
    params = state_dict_to_flax(init.denoiser.state_dict())
    jbatch = jax_random_complex_batch(np.random.default_rng(1), **kw)
    want = JaxModel.create(cfg, 8).apply(
        params, jbatch, jbatch.ligand_pos, jbatch.ligand_v, jbatch.bond_type,
        jnp.array([500]))
    batch = random_complex_batch(np.random.default_rng(1), device='cpu', **kw)
    for use_kernels in (False, True):
        got = _port_preds(dict(cfg, use_pallas=use_kernels), params, batch,
                          torch.tensor([500]))
        for key in PRED_KEYS:
            assert np.isfinite(got[key].numpy()).all()
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       **RELEASED_TOL, err_msg=key)


def test_param_bridge_is_strict():
    _, params, _ = _jax_reference('released')
    model = DecompDiffModel.create(tiny_model_config(), 8, device='cpu')
    state = flax_to_state_dict(params)
    assert set(state) == set(dict(model.denoiser.named_parameters()))
    assert 'refine_net.layer_0.bond_layer.hk_a_kernel' in state
    back = flax_to_state_dict(state_dict_to_flax(state))
    assert all(torch.equal(back[k], state[k]) for k in state)

    tree = params['params']
    missing = {k: v for k, v in tree.items() if k != 'v_inf_1'}
    with pytest.raises(KeyError, match='missing'):
        load_flax_params(model.denoiser, {'params': missing})
    extra = dict(tree, unused_head={'kernel': np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match='unexpected'):
        load_flax_params(model.denoiser, {'params': extra})
    wrong = dict(tree, v_inf_1=dict(tree['v_inf_1'],
                                    bias=np.zeros(3, np.float32)))
    with pytest.raises(ValueError, match='shape'):
        load_flax_params(model.denoiser, {'params': wrong})


# The bf16 options of the kernel path, each against the JAX kernel path with
# the same keys (Pallas in interpret mode): (tolerance, the prediction the
# option moves most against the float32 dense path, by at least this much).
BF16_OPTIONS = {
    'pallas_bf16': (dict(rtol=1e-3, atol=1e-3), 'pred_bond', 2e-3),
    'pallas_gather_bf16': (TINY_TOL, 'pred_ligand_pos', 5e-4)}


@pytest.mark.parametrize('option', sorted(BF16_OPTIONS))
def test_tiny_denoiser_bf16_matches_jax(option):
    """use_pallas with a bf16 option (on the CPU the kernels' plain versions
    with the same roundings) against the JAX kernel path.
    pallas_bf16 at the bf16 tolerance of tests/test_torch_kernels.py, rtol /
    atol 1e-3: a y within float32 rounding of a bf16 rounding boundary can
    round the other way in the two (measured up to 3e-4 here, seeds 0-2),
    while the option moves pred_bond by ~4e-3. pallas_gather_bf16 at the
    float32 tolerance: it rounds h and x, which enter each layer, not a
    per-pair y, and no value here lies within float32 rounding of a bf16
    boundary (measured 7.2e-7), while the option moves pred_ligand_pos by
    ~1e-3."""
    _, params, want32 = _jax_reference('released')
    cfg = tiny_model_config(use_pallas=True, **{option: True})
    jbatch = jax_random_complex_batch(np.random.default_rng(0))
    want = JaxModel.create(cfg, 8).apply(
        params, jbatch, jbatch.ligand_pos, jbatch.ligand_v, jbatch.bond_type,
        jnp.array([7, 31]))
    batch = random_complex_batch(np.random.default_rng(0), device='cpu')
    got = _port_preds(cfg, params, batch, torch.tensor([7, 31]))
    tol, moved, least = BF16_OPTIONS[option]
    for key in PRED_KEYS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **tol, err_msg=key)
    assert np.abs(got[moved].numpy() - want32[moved]).max() > least


def _tiny_preds(cfg):
    """The tiny config's predictions from seed-0 weights (CPU)."""
    model = DecompDiffModel.create(cfg, 8, device='cpu', seed=0)
    batch = random_complex_batch(np.random.default_rng(0), device='cpu')
    with torch.no_grad():
        return model.apply(batch, batch.ligand_pos, batch.ligand_v,
                           batch.bond_type, torch.tensor([7, 31]))


def test_config_keys():
    """use_pallas selects the kernels; with them pallas_bf16 selects the
    triplet kernel's bf16 forward and pallas_gather_bf16 the edge kernels'
    bf16 source table (the plain path ignores both); the two TPU tiling
    keys are accepted and change nothing; model_type uni_o2 builds the
    non-bond refine net."""
    tuning = dict(pallas_triplet_i_block=4, pallas_edge_tile=128)
    cfg = tiny_model_config(use_pallas=True, pallas_bf16=True,
                            pallas_gather_bf16=True, **tuning)
    model = DecompDiffModel.create(cfg, 8, device='cpu')
    layer = model.denoiser.refine_net.layer_0
    assert layer.bond_layer.use_kernels and layer.bond_layer.bf16
    assert layer.node_layer_with_edge.gather_bf16
    assert layer.pos_layer_with_edge.gather_bf16
    layer = DecompDiffModel.create(tiny_model_config(use_pallas=True), 8,
                                   device='cpu').denoiser.refine_net.layer_0
    assert not layer.bond_layer.bf16
    assert not layer.node_layer_with_edge.gather_bf16
    for use_pallas in (False, True):
        base = tiny_model_config(use_pallas=use_pallas)
        plain = _tiny_preds(base)
        same = _tiny_preds(dict(base, **tuning))
        bf16 = _tiny_preds(dict(base, pallas_bf16=True))
        gather = _tiny_preds(dict(base, pallas_gather_bf16=True))
        for key in PRED_KEYS:
            assert torch.equal(same[key], plain[key]), key
        assert torch.equal(bf16['pred_bond'], plain['pred_bond']) \
            != use_pallas
        for key in PRED_KEYS:
            assert torch.equal(gather[key], plain[key]) != use_pallas, key
    o2 = DecompDiffModel.create(
        dict(cfg, model_type='uni_o2', bond_net_type='pre_att'), 8,
        device='cpu').denoiser
    assert type(o2.refine_net).__name__ == 'UniTransformerO2'
    assert o2.refine_net.layer_0.x2h_0.use_kernels
    assert not hasattr(o2, 'ligand_bond_emb')


def test_center_by_protein_matches_jax():
    kw = dict(real_protein=17)
    jb = jax_random_complex_batch(np.random.default_rng(2), **kw)
    tb = random_complex_batch(np.random.default_rng(2), device='cpu', **kw)
    for mode in ('protein', 'none'):
        got = center_by_protein(tb, tb.ligand_pos, mode)
        want = jax_center_by_protein(jb, jb.ligand_pos, mode)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)

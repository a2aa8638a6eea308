"""The port against the float64 reference oracle (tests/reference_oracle.py),
loaded through its own converter from a reference-layout state dict: the
chain reference weights -> decompdiff_tpu_torch/utils/convert_checkpoint.py
-> the port's padded model, held against the ragged numpy transcription of
the reference math, as tests/test_oracle_parity.py and
tests/test_oracle_extended.py hold the JAX package.

Tolerances are theirs: forward and reverse-step positions rtol = atol =
3e-4 (float32 model against a float64 oracle, through 2 layers), losses
5e-4, types exactly equal under injected draws.
"""

import numpy as np
import pytest
import torch

from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
from decompdiff_tpu_torch.sampling.sampler import (
    SampleConfig, sample_diffusion)
from decompdiff_tpu_torch.utils.convert_checkpoint import (
    convert_reference_state_dict)
from decompdiff_tpu_torch.utils.params import load_flax_params
from decompdiff_tpu_torch.utils.testing import (
    DEFAULT_MODEL_CONFIG, padded_complex_batch, ragged_arrays,
    ragged_complexes, tiny_model_config)
from tests import reference_oracle as oracle

torch.set_num_threads(2)
NUM_CLASSES, NUM_BOND, PROTEIN_FEAT, K = 8, 5, 29, 8
FWD_TOL = dict(rtol=3e-4, atol=3e-4)
LOSS_TOL = dict(rtol=5e-4, atol=5e-4)


def _config(**over):
    cfg = tiny_model_config(knn=K, num_layers=2, hidden_dim=32, n_heads=4,
                            use_pallas=True)
    cfg.update(over)
    return cfg


def _case(cfg, seed=7, sd_seed=11, o2=False, prior=False):
    graphs = ragged_complexes(np.random.default_rng(seed))
    if prior:
        # one std per group, as the prior-node transform emits it
        for g in graphs:
            g['prior_stds'] = np.repeat(g['prior_stds'][:, :1], 3, axis=1)
    make = (oracle.make_reference_state_dict_o2 if o2
            else oracle.make_reference_state_dict)
    sd = make(np.random.default_rng(sd_seed), cfg, NUM_CLASSES, NUM_BOND,
              PROTEIN_FEAT, NUM_CLASSES + 2)
    if prior:
        sd = oracle.extend_state_dict_prior(sd, np.random.default_rng(14),
                                            cfg)
    model = DecompDiffModel.create(cfg, NUM_CLASSES, device='cpu')
    load_flax_params(model.denoiser, convert_reference_state_dict(sd, cfg))
    batch = padded_complex_batch(graphs, device='cpu')
    return graphs, ragged_arrays(graphs), batch, sd, model


def _ragged_args(r):
    return (r['protein_pos'], r['protein_feat'], r['batch_protein'],
            r['ligand_pos'], r['ligand_v'], r['aux'], r['batch_ligand'])


def _compare(preds, opreds, ragged, graphs, bonds=True):
    pos = preds['pred_ligand_pos'].double().numpy()
    v = preds['pred_ligand_v'].double().numpy()
    off = 0
    for b, g in enumerate(graphs):
        n = len(g['ligand_pos'])
        np.testing.assert_allclose(pos[b, :n],
                                   opreds['pred_ligand_pos'][off:off + n],
                                   **FWD_TOL, err_msg=f'pos graph {b}')
        np.testing.assert_allclose(v[b, :n],
                                   opreds['pred_ligand_v'][off:off + n],
                                   **FWD_TOL, err_msg=f'v graph {b}')
        off += n
    if bonds:
        bond = preds['pred_bond'].double().numpy()
        got = np.stack([bond[gi, i, j] for gi, i, j in ragged['bond_local']])
        np.testing.assert_allclose(got, opreds['pred_bond'], **FWD_TOL,
                                   err_msg='pred_bond')


def _apply(model, batch, t=(3, 7)):
    with torch.no_grad():
        return model.apply(batch, batch.ligand_pos, batch.ligand_v,
                           batch.bond_type, torch.as_tensor(t))


def test_fixtures_match_the_jax_oracle_tests():
    """utils/testing.py's ragged complexes and padded batch are
    tests/test_oracle_parity.py's, array for array."""
    from tests.test_oracle_parity import _padded_batch, _ragged_fixture
    want = _ragged_fixture(np.random.default_rng(7))
    got = ragged_complexes(np.random.default_rng(7))
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    jb, tb = _padded_batch(want), padded_complex_batch(got, device='cpu')
    for k, v in vars(tb).items():
        if v is None:
            assert getattr(jb, k) is None, k
            continue
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(jb, k)),
                                      err_msg=k)


@pytest.mark.parametrize('bond_net_type,x2h_out_fc', [
    ('lin', False), ('pre_att', False), ('lin', True)])
def test_forward_matches_oracle(bond_net_type, x2h_out_fc):
    cfg = _config(bond_net_type=bond_net_type, x2h_out_fc=x2h_out_fc)
    graphs, ragged, batch, sd, model = _case(cfg)
    opreds = oracle.decomp_forward(
        sd, cfg, NUM_CLASSES, NUM_BOND, *_ragged_args(ragged),
        ragged['bond_index'], ragged['bond_type'])
    _compare(_apply(model, batch), opreds, ragged, graphs)


def test_released_width_forward_matches_oracle():
    """The released uni_o2_bond config (hidden 128, 6 layers, 16 heads,
    k 32) at B=1, Np=64, Nl=16, the size at which the float64 oracle stays
    cheap; chip_smoke.py holds the kernels to the same check."""
    cfg = dict(DEFAULT_MODEL_CONFIG, use_pallas=True)
    graphs = ragged_complexes(np.random.default_rng(4), sizes=((64, 16, 2),))
    ragged = ragged_arrays(graphs)
    sd = oracle.make_reference_state_dict(np.random.default_rng(3), cfg,
                                          NUM_CLASSES, NUM_BOND, PROTEIN_FEAT,
                                          NUM_CLASSES + 2)
    model = DecompDiffModel.create(cfg, NUM_CLASSES, device='cpu')
    load_flax_params(model.denoiser, convert_reference_state_dict(sd, cfg))
    batch = padded_complex_batch(graphs, 64, 16, 4, device='cpu')
    opreds = oracle.decomp_forward(
        sd, cfg, NUM_CLASSES, NUM_BOND, *_ragged_args(ragged),
        ragged['bond_index'], ragged['bond_type'])
    _compare(_apply(model, batch, t=(3,)), opreds, ragged, graphs)


@pytest.mark.parametrize('ew', ['global', 'r', 'm', 'none'])
def test_uni_o2_forward_matches_oracle(ew):
    bond = ew == 'global'       # the pre_att bond head on one of them
    cfg = _config(model_type='uni_o2', ew_net_type=ew, bond_diffusion=bond,
                  bond_net_type='pre_att' if bond else 'lin')
    graphs, ragged, batch, sd, model = _case(cfg, o2=True)
    opreds = oracle.decomp_forward_o2(
        sd, cfg, NUM_CLASSES, NUM_BOND, *_ragged_args(ragged),
        ligand_fc_bond_index=ragged['bond_index'] if bond else None)
    _compare(_apply(model, batch), opreds, ragged, graphs, bonds=bond)


def test_prior_node_forward_matches_oracle():
    cfg = _config(add_prior_node=True, edge_feat_dim=6)
    graphs, ragged, batch, sd, model = _case(cfg, seed=9, sd_seed=13,
                                             prior=True)
    opreds = oracle.decomp_forward_prior(
        sd, cfg, NUM_CLASSES, NUM_BOND, *_ragged_args(ragged),
        np.concatenate([g['decomp_idx'] for g in graphs]),
        np.concatenate([g['prior_centers'] for g in graphs]),
        np.concatenate([g['prior_stds'][:, 0] for g in graphs]),
        np.concatenate([np.full(g['num_arms'] + 1, i)
                        for i, g in enumerate(graphs)]),
        np.concatenate([np.arange(g['num_arms'] + 1) for g in graphs]),
        ragged['bond_index'], ragged['bond_type'])
    _compare(_apply(model, batch), opreds, ragged, graphs)


@pytest.mark.parametrize('bond_net_type', ['lin', 'pre_att'])
@pytest.mark.parametrize('tval', [(3, 17), (0, 9)])
def test_loss_matches_oracle(bond_net_type, tval):
    cfg = _config(bond_net_type=bond_net_type)
    graphs, ragged, batch, sd, model = _case(cfg)
    rng = np.random.default_rng(23)
    B, Nl = batch.batch_size, batch.num_ligand_atoms
    lig_mask, bond_mask = batch.ligand_mask.numpy(), batch.bond_mask.numpy()
    pos_noise = np.zeros((B, Nl, 3), np.float32)
    v_pert = np.zeros((B, Nl), np.int64)
    for b, g in enumerate(graphs):
        n = len(g['ligand_pos'])
        pos_noise[b, :n] = rng.normal(size=(n, 3))
        v_pert[b, :n] = rng.integers(0, NUM_CLASSES, size=(n,))
    b_pert = np.where(bond_mask, rng.integers(0, NUM_BOND, (B, Nl, Nl)), 0)
    v_pert = np.where(lig_mask, v_pert, 0)
    t = np.asarray(tval, np.int64)
    with torch.no_grad():
        out = model.get_diffusion_loss(
            batch, time_step=torch.as_tensor(t), noise_override={
                'pos_noise': torch.as_tensor(pos_noise),
                'v_perturbed': torch.as_tensor(v_pert),
                'b_perturbed': torch.as_tensor(b_pert)})
    sizes = [len(g['ligand_pos']) for g in graphs]
    oloss = oracle.decomp_loss(
        sd, cfg, NUM_CLASSES, NUM_BOND, *_ragged_args(ragged),
        ragged['atom_centers'], ragged['atom_stds'], ragged['bond_index'],
        ragged['bond_type'], ragged['batch_bond'], t,
        np.concatenate([pos_noise[b, :n] for b, n in enumerate(sizes)]
                       ).astype(np.float64),
        np.concatenate([v_pert[b, :n] for b, n in enumerate(sizes)]),
        np.array([b_pert[gi, i, j] for gi, i, j in ragged['bond_local']]))
    for key in ('pos', 'v', 'bond'):
        np.testing.assert_allclose(float(out['losses'][key]),
                                   float(oloss[key]), **LOSS_TOL,
                                   err_msg=f'loss {key} (t={tval})')


def test_reverse_step_matches_oracle():
    """One ancestral step at t = T-1 with injected draws: positions at the
    forward tolerance, atom and bond types exactly."""
    cfg = _config(bond_net_type='lin', num_diffusion_timesteps=50)
    graphs, ragged, batch, sd, model = _case(cfg, seed=31)
    rng = np.random.default_rng(31)
    ragged_complexes(rng)                      # the fixture's own draws
    B, Nl = batch.batch_size, batch.num_ligand_atoms
    pos_eps = np.zeros((1, B, Nl, 3), np.float32)
    v_uniform = rng.random((1, B, Nl, NUM_CLASSES)).astype(np.float32)
    b_uniform = rng.random((1, B, Nl, Nl, NUM_BOND)).astype(np.float32)
    sizes = [len(g['ligand_pos']) for g in graphs]
    for b, n in enumerate(sizes):
        pos_eps[0, b, :n] = rng.normal(size=(n, 3))
    out = sample_diffusion(
        model, SampleConfig(num_steps=1, save_traj=False), batch,
        batch.ligand_pos, batch.ligand_v, batch.bond_type,
        noise_override={'pos_eps': torch.as_tensor(pos_eps),
                        'v_uniform': torch.as_tensor(v_uniform),
                        'b_uniform': torch.as_tensor(b_uniform)})

    t = np.full(len(graphs), cfg['num_diffusion_timesteps'] - 1, np.int64)
    offset = oracle.scatter_mean(ragged['protein_pos'],
                                 ragged['batch_protein'], len(graphs))
    prot_c = ragged['protein_pos'] - offset[ragged['batch_protein']]
    lig_c = ragged['ligand_pos'] - offset[ragged['batch_ligand']]
    opreds = oracle.decomp_forward(
        sd, cfg, NUM_CLASSES, NUM_BOND, prot_c, ragged['protein_feat'],
        ragged['batch_protein'], lig_c, ragged['ligand_v'], ragged['aux'],
        ragged['batch_ligand'], ragged['bond_index'], ragged['bond_type'])
    pos_next, v_next, b_next = oracle.reverse_step(
        cfg, NUM_CLASSES, NUM_BOND, opreds, lig_c, ragged['ligand_v'],
        ragged['bond_type'], ragged['atom_stds'], t, ragged['batch_ligand'],
        ragged['batch_bond'],
        np.concatenate([pos_eps[0, b, :n] for b, n in enumerate(sizes)]
                       ).astype(np.float64),
        np.concatenate([v_uniform[0, b, :n] for b, n in enumerate(sizes)]
                       ).astype(np.float64),
        np.stack([b_uniform[0, gi, i, j]
                  for gi, i, j in ragged['bond_local']]).astype(np.float64))
    pos_next = pos_next + offset[ragged['batch_ligand']]

    got_pos = out['pos'].double().numpy()
    got_v, got_b = out['v'].numpy(), out['bond'].numpy()
    off = 0
    for b, n in enumerate(sizes):
        np.testing.assert_allclose(got_pos[b, :n], pos_next[off:off + n],
                                   **FWD_TOL, err_msg=f'pos_next graph {b}')
        np.testing.assert_array_equal(got_v[b, :n], v_next[off:off + n],
                                      err_msg=f'v_next graph {b}')
        off += n
    np.testing.assert_array_equal(
        [got_b[gi, i, j] for gi, i, j in ragged['bond_local']], b_next)

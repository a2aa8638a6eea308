"""Synthetic fixture builders for tests and the chip smoke run (port of
decompdiff_tpu/utils/testing.py). The numpy draws are the same, in the same
order, so one seed gives bit-identical batches in both packages."""

from __future__ import annotations

import numpy as np
import torch

from decompdiff_tpu_torch.constants import PROTEIN_FEATURE_DIM
from decompdiff_tpu_torch.data.batch import ComplexBatch, make_bond_mask
from decompdiff_tpu_torch.device import DeviceLike, resolve_device


DEFAULT_MODEL_CONFIG = {
    # released hyperparameters (ref configs/training.yml)
    'model_mean_type': 'C0',
    'beta_schedule': 'sigmoid',
    'beta_start': 1.0e-7,
    'beta_end': 2.0e-3,
    'v_beta_schedule': 'cosine',
    'v_beta_s': 0.01,
    'num_diffusion_timesteps': 1000,
    'loss_pos_type': 'mse',
    'sample_time_method': 'symmetric',
    'bond_diffusion': True,
    'bond_net_type': 'lin',
    'num_bond_classes': 5,
    'prior_types': False,
    'h_node_in_bond_net': True,
    'add_prior_node': False,
    'time_emb_dim': 0,
    'time_emb_mode': 'simple',
    'center_pos_mode': 'protein',
    'node_indicator': True,
    'model_type': 'uni_o2_bond',
    'num_blocks': 1,
    'num_layers': 6,
    'hidden_dim': 128,
    'n_heads': 16,
    'edge_feat_dim': 4,
    'num_r_gaussian': 20,
    'knn': 32,
    'act_fn': 'relu',
    'norm': True,
    'cutoff_mode': 'knn',
    'r_max': 10.0,
    'x2h_out_fc': False,
    'sync_twoup': False,
    'use_global_ew': True,
}


def uni_o2_model_config(**overrides) -> dict:
    """The released widths (DEFAULT_MODEL_CONFIG) with the non-bond uni_o2
    refine net, its m-gated edge weights, and the pre_att bond head (the
    bond-diffusion setting tests/test_uni_o2.py builds)."""
    cfg = dict(DEFAULT_MODEL_CONFIG, model_type='uni_o2', ew_net_type='m',
               bond_diffusion=True, bond_net_type='pre_att')
    cfg.update(overrides)
    return cfg


def tiny_model_config(**overrides) -> dict:
    """A scaled-down config for fast CPU tests."""
    cfg = dict(DEFAULT_MODEL_CONFIG)
    cfg.update({
        'num_layers': 2,
        'hidden_dim': 32,
        'n_heads': 4,
        'knn': 8,
        'num_diffusion_timesteps': 50,
    })
    cfg.update(overrides)
    return cfg


def random_complex_batch(rng: np.random.Generator, batch_size=2,
                         num_protein=24, num_ligand=10, num_groups=4,
                         num_classes=8, feat_dim=PROTEIN_FEATURE_DIM + 2,
                         real_protein=None, real_ligand=None,
                         device: DeviceLike = None) -> ComplexBatch:
    """A random but internally-consistent padded complex batch."""
    device = resolve_device(device)
    B, Np, Nl, A = batch_size, num_protein, num_ligand, num_groups
    real_p = np.full(B, Np if real_protein is None else real_protein)
    real_l = np.full(B, Nl if real_ligand is None else real_ligand)

    protein_mask = np.arange(Np)[None, :] < real_p[:, None]
    ligand_mask = np.arange(Nl)[None, :] < real_l[:, None]

    protein_pos = rng.normal(size=(B, Np, 3)).astype(np.float32) * 4.0
    ligand_pos = rng.normal(size=(B, Nl, 3)).astype(np.float32) * 2.0
    protein_feat = (rng.random((B, Np, feat_dim)) < 0.15).astype(np.float32)

    num_arms = rng.integers(1, A, size=(B,))
    # group id per atom: arms 0..num_arms-1, scaffold = num_arms
    decomp = np.zeros((B, Nl), np.int64)
    for b in range(B):
        decomp[b] = rng.integers(0, num_arms[b] + 1, size=(Nl,))
    prior_mask = np.arange(A)[None, :] <= num_arms[:, None]
    prior_centers = rng.normal(size=(B, A, 3)).astype(np.float32) * 3.0
    prior_stds = (0.6 + rng.random((B, A, 3))).astype(np.float32)
    prior_num = np.zeros((B, A), np.int64)
    for b in range(B):
        for a in range(A):
            prior_num[b, a] = int(((decomp[b] == a) & ligand_mask[b]).sum())

    ligand_v = rng.integers(0, num_classes, size=(B, Nl))
    arm_ind = (decomp < num_arms[:, None]).astype(np.int64)
    ligand_aux = np.stack([1 - arm_ind, arm_ind], axis=-1).astype(np.float32)

    bond_type = rng.integers(0, 5, size=(B, Nl, Nl))
    bond_type = np.triu(bond_type, 1)
    bond_type = bond_type + bond_type.transpose(0, 2, 1)
    bond_mask = make_bond_mask(ligand_mask)
    bond_type = np.where(bond_mask, bond_type, 0)

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    return ComplexBatch(
        protein_pos=t(protein_pos),
        protein_feat=t(protein_feat),
        protein_mask=t(protein_mask),
        ligand_pos=t(ligand_pos),
        ligand_v=t(ligand_v, torch.int32),
        ligand_aux=t(ligand_aux),
        ligand_mask=t(ligand_mask),
        ligand_decomp_idx=t(decomp, torch.int32),
        bond_type=t(bond_type, torch.int32),
        bond_mask=t(bond_mask),
        prior_centers=t(prior_centers),
        prior_stds=t(prior_stds),
        prior_num_atoms=t(prior_num, torch.int32),
        prior_mask=t(prior_mask),
        num_arms=t(num_arms, torch.int32),
    )

"""The denoiser network: embeddings + refine net + inference heads (port of
decompdiff_tpu/models/denoiser.py; ref DecompScorePosNet3D.forward,
models/decompdiff.py:213-351).

  * ligand input = one_hot(v) ++ decomp aux feature (+ optional time feature)
  * protein/ligand Linear embeddings to hidden_dim - 1 plus a 0/1 node
    indicator (ref :245-256); with prior nodes hidden_dim - 3 and a 3-way
    indicator (ref :247-250)
  * refine net over the static [protein | ligand (| prior)] context, by
    `model_type`: 'uni_o2_bond' (uni_transformer_bond.py), which also embeds
    the bond types (`ligand_bond_emb`) and carries a bond hidden state, or
    'uni_o2' (uni_transformer.py), which has no bond stream and always runs
    4 edge types (the prior nodes' group ids are not passed to it)
  * v head Linear -> ShiftedSoftplus -> Linear (ref :194-198)
  * with bond diffusion, a bond head: 'lin' reads the bond hidden state, so
    it needs 'uni_o2_bond'; 'pre_att' builds RBF(dist) ++ (h_i + h_j)/2
    over the final ligand atoms (ref :323-341) and works with both nets

Submodule names are the flax ones (`protein_atom_emb`, `refine_net`, ...).
The config key `use_pallas` selects the CUDA kernels, and with them, for
uni_o2_bond (the JAX uni_o2 net reads neither), `pallas_bf16` the triplet
kernel's bf16 second linears and `pallas_gather_bf16` the edge kernels'
sources from the bf16 node table of the JAX kernel path; the plain path
ignores both, as the JAX dense path does. The JAX package's TPU tiling keys
(`pallas_triplet_i_block`, `pallas_edge_tile`) change no value there and
are accepted and unused here.

`compute_dtype: bfloat16` is the JAX denoiser's bf16 compute path
(denoiser.py:157-168): the parameters stay float32; the composed context
h is cast to bf16, the bond one-hot and `ligand_bond_emb` are formed in
bf16, and uni_o2_bond computes in bf16 (uni_o2 takes only the bf16 h; see
the two nets' docstrings); the heads take float32 outputs, so every
prediction is float32. `remat: true` is refused on uni_o2_bond: the JAX
package cannot run it there (see __init__), so nothing defines what the
port should compute; uni_o2 ignores the key, as JAX does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from decompdiff_tpu_torch.constants import PROTEIN_FEATURE_DIM
from decompdiff_tpu_torch.data.batch import ComplexBatch
from decompdiff_tpu_torch.models.common import (
    Dense, linspace_rbf, shifted_softplus)
from decompdiff_tpu_torch.models.uni_transformer import UniTransformerO2
from decompdiff_tpu_torch.models.uni_transformer_bond import UniTransformerBond


COMPUTE_DTYPES = {None: None, 'float32': None, 'bfloat16': torch.bfloat16}


def sinusoidal_time_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """ref models/decompdiff.py:59-71."""
    half = dim // 2
    emb = np.log(10000) / (half - 1)
    freqs = torch.exp(torch.arange(half, device=t.device) * -emb)
    args = t[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class DecompDenoiser(nn.Module):
    """One forward pass of the joint (pos, atom-type, bond-type) denoiser."""

    def __init__(self, config: dict, num_classes: int, num_bond_classes: int,
                 protein_feat_dim: int = PROTEIN_FEATURE_DIM + 2,
                 ligand_aux_dim: int = 2):
        super().__init__()
        cfg = self.config = dict(config)
        self.num_classes, self.num_bond_classes = num_classes, num_bond_classes
        self.model_type = cfg.get('model_type', 'uni_o2_bond')
        if self.model_type not in ('uni_o2_bond', 'uni_o2'):
            raise ValueError(self.model_type)
        if cfg.get('compute_dtype') not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {cfg['compute_dtype']!r}, "
                             "expected 'float32' or 'bfloat16'")
        self.compute_dtype = COMPUTE_DTYPES[cfg.get('compute_dtype')]
        if cfg.get('remat', False) and self.model_type == 'uni_o2_bond':
            raise NotImplementedError(
                'remat: true on uni_o2_bond fails in the JAX package itself '
                '(dense path: IndexError "Slice entries must be static '
                'integers"; kernel path: UnexpectedTracerError, a tracer '
                'passed as a nondiff_argnums argument of a custom_vjp), so '
                'it has no reference to port; uni_o2 ignores the key')
        H = cfg['hidden_dim']
        self.node_indicator = cfg.get('node_indicator', True)
        self.add_prior_node = cfg.get('add_prior_node', False)
        emb_dim = H - (3 if self.add_prior_node else 1) \
            if self.node_indicator else H

        lig_in = num_classes + ligand_aux_dim
        self.time_emb_dim = cfg.get('time_emb_dim', 0)
        self.time_emb_mode = cfg.get('time_emb_mode', 'simple')
        if self.time_emb_dim > 0:
            if self.time_emb_mode == 'simple':
                lig_in += 1
            elif self.time_emb_mode == 'sin':
                t = self.time_emb_dim
                self.Dense_0 = Dense(t, 4 * t)
                self.Dense_1 = Dense(4 * t, t)
                lig_in += t
            else:
                raise NotImplementedError(self.time_emb_mode)

        self.protein_atom_emb = Dense(protein_feat_dim, emb_dim)
        self.ligand_atom_emb = Dense(lig_in, emb_dim)
        if self.add_prior_node:
            self.prior_atom_emb = Dense(20, emb_dim)
        net = dict(num_blocks=cfg['num_blocks'], num_layers=cfg['num_layers'],
                   hidden_dim=H, n_heads=cfg['n_heads'], k=cfg['knn'],
                   x2h_out_fc=cfg.get('x2h_out_fc', True),
                   use_kernels=cfg.get('use_pallas', False),
                   cutoff_mode=cfg.get('cutoff_mode', 'knn'),
                   r_max=cfg.get('r_max', 10.0))
        if self.model_type == 'uni_o2_bond':
            self.ligand_bond_emb = Dense(num_bond_classes, H,
                                         dtype=self.compute_dtype)
            self.refine_net = UniTransformerBond(
                include_h_node=cfg.get('h_node_in_bond_net', False),
                n_etypes=6 if self.add_prior_node else 4,
                triplet_bf16=cfg.get('pallas_bf16', False),
                gather_bf16=cfg.get('pallas_gather_bf16', False),
                dtype=self.compute_dtype, **net)
        else:
            self.refine_net = UniTransformerO2(
                ew_net_type=cfg.get('ew_net_type', 'global'),
                num_x2h=cfg.get('num_x2h', 1), num_h2x=cfg.get('num_h2x', 1),
                sync_twoup=cfg.get('sync_twoup', False), **net)
        self.v_inf_0 = Dense(H, H)
        self.v_inf_1 = Dense(H, num_classes)
        self.bond_diffusion = cfg.get('bond_diffusion', False)
        if self.bond_diffusion:
            self.bond_net_type = cfg.get('bond_net_type', 'lin')
            if self.bond_net_type == 'lin':
                if self.model_type != 'uni_o2_bond':
                    raise ValueError("bond_net_type 'lin' reads the bond "
                                     "hidden state of the uni_o2_bond net")
                bond_in = H
            elif self.bond_net_type == 'pre_att':
                bond_in = cfg.get('num_r_gaussian', 20) + H
            else:
                raise ValueError(self.bond_net_type)
            self.bond_inf_0 = Dense(bond_in, H)
            self.bond_inf_1 = Dense(H, num_bond_classes)

    def forward(self, batch: ComplexBatch, ligand_pos, ligand_v, bond_type,
                time_step: Optional[torch.Tensor] = None):
        """
        Args:
            batch:      static features (protein, masks, priors, aux)
            ligand_pos: [B, Nl, 3] current (noised) ligand coordinates
            ligand_v:   [B, Nl] current atom-type indices
            bond_type:  [B, Nl, Nl] current bond-type indices
            time_step:  [B] integer t (only used when time_emb_dim > 0)

        Returns a dict with 'pred_ligand_pos' [B, Nl, 3], 'pred_ligand_v'
        [B, Nl, K] and, with bond diffusion, 'pred_bond' [B, Nl, Nl, Kb].
        """
        Np, Nl = batch.num_protein_atoms, batch.num_ligand_atoms
        B = batch.batch_size
        v_onehot = F.one_hot(ligand_v.long(), self.num_classes).float()
        lig_feat = torch.cat([v_onehot, batch.ligand_aux.float()], dim=-1)
        if self.time_emb_dim > 0:
            if self.time_emb_mode == 'simple':
                tfeat = (time_step.float()
                         / self.config['num_diffusion_timesteps'])
                tfeat = tfeat[:, None, None].expand(B, Nl, 1)
            else:
                te = sinusoidal_time_emb(time_step, self.time_emb_dim)
                te = self.Dense_1(F.gelu(self.Dense_0(te), approximate='tanh'))
                tfeat = te[:, None, :].expand(B, Nl, self.time_emb_dim)
            lig_feat = torch.cat([lig_feat, tfeat], dim=-1)

        h_protein = self.protein_atom_emb(batch.protein_feat)
        h_ligand = self.ligand_atom_emb(lig_feat)

        group_idx = None
        false_p = torch.zeros_like(batch.protein_mask)
        if self.add_prior_node:
            # prior dummy nodes embed an RBF of their mean std
            # (ref models/decompdiff.py:162-163,241-250)
            h_prior = self.prior_atom_emb(
                linspace_rbf(batch.prior_stds.mean(-1), 0.0, 5.0, 20))
            if self.node_indicator:
                def ind(h, which):
                    onehot = torch.zeros(h.shape[:-1] + (3,), dtype=h.dtype,
                                         device=h.device)
                    onehot[..., which] = 1.0
                    return torch.cat([h, onehot], dim=-1)
                h_protein, h_ligand, h_prior = (
                    ind(h_protein, 0), ind(h_ligand, 1), ind(h_prior, 2))
            h_all = torch.cat([h_protein, h_ligand, h_prior], dim=1)
            pos_all = torch.cat(
                [batch.protein_pos, ligand_pos, batch.prior_centers], dim=1)
            mask_all = torch.cat(
                [batch.protein_mask, batch.ligand_mask, batch.prior_mask], 1)
            # prior dummies count as ligand for edge typing but never move
            mask_ligand = torch.cat(
                [false_p, batch.ligand_mask, batch.prior_mask], dim=1)
            movable = torch.cat([false_p, batch.update_mask(),
                                 torch.zeros_like(batch.prior_mask)], dim=1)
            A = batch.num_groups
            group_idx = torch.cat([
                torch.full(batch.protein_mask.shape, -1, dtype=torch.int32,
                           device=h_all.device),
                batch.ligand_decomp_idx.int(),
                torch.arange(A, dtype=torch.int32,
                             device=h_all.device)[None].expand(B, A),
            ], dim=1)
        else:
            if self.node_indicator:
                h_protein = torch.cat(
                    [h_protein, torch.zeros_like(h_protein[..., :1])], -1)
                h_ligand = torch.cat(
                    [h_ligand, torch.ones_like(h_ligand[..., :1])], -1)
            h_all = torch.cat([h_protein, h_ligand], dim=1)
            pos_all = torch.cat([batch.protein_pos, ligand_pos], dim=1)
            mask_all = torch.cat([batch.protein_mask, batch.ligand_mask], 1)
            mask_ligand = torch.cat([false_p, batch.ligand_mask], dim=1)
            movable = torch.cat([false_p, batch.update_mask()], dim=1)

        if self.compute_dtype is not None:
            h_all = h_all.to(self.compute_dtype)
        if self.model_type == 'uni_o2_bond':
            bond_onehot = F.one_hot(bond_type.long(), self.num_bond_classes
                                    ).to(self.compute_dtype or torch.float32)
            outputs = self.refine_net(
                h_all, pos_all.contiguous(), self.ligand_bond_emb(bond_onehot),
                mask_all, mask_ligand, movable, batch.bond_mask,
                num_protein=Np, group_idx=group_idx)
        else:
            outputs = self.refine_net(h_all, pos_all.contiguous(), mask_all,
                                      mask_ligand, movable, num_protein=Np)

        final_h_lig = outputs['h'][:, Np:Np + Nl].float()
        final_pos_lig = outputs['x'][:, Np:Np + Nl].float()
        pred_v = self.v_inf_1(shifted_softplus(self.v_inf_0(final_h_lig)))
        preds = {'pred_ligand_pos': final_pos_lig, 'pred_ligand_v': pred_v}

        if self.bond_diffusion:
            if self.bond_net_type == 'lin':
                bond_in = outputs['h_bond'].float()
            else:
                # pair features over the dense bond graph (ref :325-333)
                diff = (final_pos_lig[:, :, None, :]
                        - final_pos_lig[:, None, :, :])
                dist = torch.sqrt(torch.clamp((diff * diff).sum(-1),
                                              min=1e-12))
                r_feat = linspace_rbf(dist, 0.0, 5.0,
                                      self.config.get('num_r_gaussian', 20))
                pair_h = ((final_h_lig[:, :, None, :]
                           + final_h_lig[:, None, :, :]) / 2)
                bond_in = torch.cat([r_feat, pair_h], dim=-1)
            preds['pred_bond'] = self.bond_inf_1(
                shifted_softplus(self.bond_inf_0(bond_in)))
        return preds

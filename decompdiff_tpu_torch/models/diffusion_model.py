"""Top-level diffusion model: transitions + denoiser (port of
decompdiff_tpu/models/diffusion_model.py, create/apply/center_by_protein;
ref DecompScorePosNet3D, models/decompdiff.py:75-147). The training loss
belongs to a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from decompdiff_tpu_torch.constants import (
    ATOM_TYPES_PROB_BASIC, BOND_TYPES_PROB, PROTEIN_FEATURE_DIM)
from decompdiff_tpu_torch.data.batch import ComplexBatch
from decompdiff_tpu_torch.device import DeviceLike, resolve_device
from decompdiff_tpu_torch.diffusion.categorical import CategoricalDiffusion
from decompdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from decompdiff_tpu_torch.models.denoiser import DecompDenoiser
from decompdiff_tpu_torch.utils.params import init_params_


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum(dim) / torch.clamp(m.sum(dim), min=1.0)


def center_by_protein(batch: ComplexBatch, ligand_pos, mode: str = 'protein'):
    """Translate each complex to its protein centroid; returns (centered
    protein pos, centered ligand pos, offset [B, 3])
    (ref models/decompdiff.py:20-32, mode 'protein' or 'none')."""
    if mode == 'none':
        return batch.protein_pos, ligand_pos, torch.zeros(
            (batch.batch_size, 3), dtype=batch.protein_pos.dtype,
            device=batch.device)
    if mode != 'protein':
        raise NotImplementedError(f'center_pos_mode={mode!r}')
    offset = masked_mean(batch.protein_pos, batch.protein_mask[..., None],
                         dim=1)
    return (batch.protein_pos - offset[:, None, :],
            ligand_pos - offset[:, None, :], offset)


@dataclasses.dataclass(frozen=True, eq=False)
class DecompDiffModel:
    """The denoiser module (which owns the parameters) with the diffusion
    processes, all on one device."""
    denoiser: DecompDenoiser
    pos_diff: GaussianDiffusion
    atom_diff: CategoricalDiffusion
    bond_diff: CategoricalDiffusion
    config: dict
    device: torch.device

    @classmethod
    def create(cls, config, num_classes: int,
               num_bond_classes: Optional[int] = None, *,
               device: DeviceLike = None, seed: int = 0,
               protein_feat_dim: int = PROTEIN_FEATURE_DIM + 2,
               ligand_aux_dim: int = 2) -> "DecompDiffModel":
        """Build the model on `device` (CUDA unless given) with parameters
        drawn from `seed` in the flax initializers' distributions; load
        trained or JAX parameters with utils.params.load_flax_params."""
        device = resolve_device(device)
        cfg = dict(config)
        num_bond_classes = num_bond_classes or cfg.get('num_bond_classes', 5)
        # the reference has atom marginals only for the 8-class 'basic'
        # vocabulary (ref utils/transforms.py:141-145)
        prior_atom = (ATOM_TYPES_PROB_BASIC
                      if cfg.get('prior_types', False)
                      and num_classes == len(ATOM_TYPES_PROB_BASIC) else None)
        prior_bond = BOND_TYPES_PROB if cfg.get('prior_types', False) else None
        denoiser = DecompDenoiser(cfg, num_classes, num_bond_classes,
                                  protein_feat_dim, ligand_aux_dim)
        init_params_(denoiser, torch.Generator().manual_seed(seed))
        # sampling takes no parameter gradients (the training slice will)
        denoiser.requires_grad_(False).to(device).eval()
        T, s = cfg['num_diffusion_timesteps'], cfg.get('v_beta_s', 0.01)
        return cls(
            denoiser=denoiser,
            pos_diff=GaussianDiffusion.create(cfg, device),
            atom_diff=CategoricalDiffusion.create(
                cfg['v_beta_schedule'], T, s, num_classes, prior_atom, device),
            bond_diff=CategoricalDiffusion.create(
                cfg['v_beta_schedule'], T, s, num_bond_classes, prior_bond,
                device),
            config=cfg,
            device=device,
        )

    @property
    def num_timesteps(self) -> int:
        return self.config['num_diffusion_timesteps']

    @property
    def bond_diffusion(self) -> bool:
        return bool(self.config.get('bond_diffusion', False))

    def apply(self, batch: ComplexBatch, ligand_pos, ligand_v, bond_type,
              time_step):
        return self.denoiser(batch, ligand_pos, ligand_v, bond_type,
                             time_step)

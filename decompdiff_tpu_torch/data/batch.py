"""Fixed-shape padded batch structures (port of decompdiff_tpu/data/batch.py).

Dense [B, ...] tensors and boolean masks replace ragged graphs:
    B  — complexes per batch
    Np — padded protein pocket atoms
    Nl — padded ligand atoms
    A  — padded decomposition groups (arms + 1 scaffold slot; the scaffold
         group index of sample b is `num_arms[b]`)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _map(obj, fn):
    return dataclasses.replace(obj, **{
        f.name: fn(getattr(obj, f.name))
        for f in dataclasses.fields(obj) if getattr(obj, f.name) is not None})


def _to(obj, device, non_blocking=False):
    return _map(obj, lambda t: t.to(device, non_blocking=non_blocking))


@dataclasses.dataclass
class ComplexBatch:
    # --- protein pocket ---
    protein_pos: torch.Tensor       # [B, Np, 3] float32
    protein_feat: torch.Tensor      # [B, Np, Fp] float32 (27 base + 2 decomp ind)
    protein_mask: torch.Tensor      # [B, Np] bool

    # --- ligand ---
    ligand_pos: torch.Tensor        # [B, Nl, 3] float32
    ligand_v: torch.Tensor          # [B, Nl] int32 atom-type class
    ligand_aux: torch.Tensor        # [B, Nl, Fa] float32 (arm/scaffold indicator)
    ligand_mask: torch.Tensor       # [B, Nl] bool
    ligand_decomp_idx: torch.Tensor  # [B, Nl] int32 group id (scaffold = num_arms)

    # --- dense fc bond graph (entry [b, i, j] = bond j -> i) ---
    bond_type: torch.Tensor         # [B, Nl, Nl] int32 (0 = none)
    bond_mask: torch.Tensor         # [B, Nl, Nl] bool (i != j, both atoms real)

    # --- decomposed priors ---
    prior_centers: torch.Tensor     # [B, A, 3] float32
    prior_stds: torch.Tensor        # [B, A, 3] float32
    prior_num_atoms: torch.Tensor   # [B, A] int32
    prior_mask: torch.Tensor        # [B, A] bool (num_arms + 1 entries valid)
    num_arms: torch.Tensor          # [B] int32

    # 1 = atom participates in generation / may move; 0 = frozen
    # (ref models/decompdiff.py:597,621-622,682-683)
    ligand_update_mask: Optional[torch.Tensor] = None  # [B, Nl] bool

    def to(self, device, non_blocking: bool = False) -> "ComplexBatch":
        return _to(self, device, non_blocking)

    def pin_memory(self) -> "ComplexBatch":
        """The batch in page-locked host memory, from which a copy with
        non_blocking=True overlaps the device's work."""
        return _map(self, lambda t: t.pin_memory())

    def replace(self, **changes) -> "ComplexBatch":
        return dataclasses.replace(self, **changes)

    @property
    def device(self) -> torch.device:
        return self.protein_pos.device

    @property
    def batch_size(self) -> int:
        return self.protein_pos.shape[0]

    @property
    def num_protein_atoms(self) -> int:
        return self.protein_pos.shape[1]

    @property
    def num_ligand_atoms(self) -> int:
        return self.ligand_pos.shape[1]

    @property
    def num_groups(self) -> int:
        return self.prior_centers.shape[1]

    def update_mask(self) -> torch.Tensor:
        if self.ligand_update_mask is None:
            return self.ligand_mask
        return self.ligand_update_mask & self.ligand_mask

    def _per_atom(self, table: torch.Tensor) -> torch.Tensor:
        idx = self.ligand_decomp_idx.long()[..., None].expand(-1, -1, 3)
        return torch.gather(table, 1, idx)

    def atom_prior_centers(self) -> torch.Tensor:
        """Per-atom prior centers [B, Nl, 3], gathered by decomp index
        (ref models/decompdiff.py:438)."""
        return self._per_atom(self.prior_centers)

    def atom_prior_stds(self) -> torch.Tensor:
        """Per-atom prior stds [B, Nl, 3] (ref models/decompdiff.py:439)."""
        return self._per_atom(self.prior_stds)


@dataclasses.dataclass
class FullProtein:
    """The complete (un-cropped) protein, used only by clash guidance
    (ref scripts/sample_diffusion_decomp.py:564-565)."""
    pos: torch.Tensor   # [B, Nfull, 3]
    mask: torch.Tensor  # [B, Nfull] bool

    def to(self, device) -> "FullProtein":
        return _to(self, device)


def make_bond_mask(ligand_mask: np.ndarray) -> np.ndarray:
    """[B, Nl] -> [B, Nl, Nl] fc bond mask (i != j, both real)."""
    m = ligand_mask
    pair = m[..., :, None] & m[..., None, :]
    eye = np.eye(m.shape[-1], dtype=bool)
    return pair & ~eye
